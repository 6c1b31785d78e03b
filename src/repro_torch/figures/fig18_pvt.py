"""Fig. 18: σ_E and INL across supply voltage (0.65–1.2 V), temperature
(−40–105 °C), gains (1–4), and process instances (8 groups × 5 chips)."""
import dataclasses
import time

import torch

from repro_torch.core import PROTOTYPE
from repro_torch.core.macro import OperatingPoint
from repro_torch.device import resolve_device

from .common import inl_curve_eager, linspace0, row


def run(device=None):
    dev = resolve_device(device)
    out = []
    t0 = time.perf_counter()
    for vdd in (0.65, 0.8, 0.9, 1.0, 1.2):
        m = dataclasses.replace(PROTOTYPE, op=OperatingPoint(vdd=vdd))
        out.append(row(f"fig18_vdd{vdd:g}", (time.perf_counter() - t0) * 1e6,
                       f"sigma_e={m.sigma_e_lsb():.3f}LSB|"
                       f"levels={m.effective_adc_levels()}"))
    for temp in (-40.0, 25.0, 105.0):
        m = dataclasses.replace(PROTOTYPE,
                                op=OperatingPoint(temp_c=temp))
        out.append(row(f"fig18_temp{temp:g}",
                       (time.perf_counter() - t0) * 1e6,
                       f"sigma_e={m.sigma_e_lsb():.3f}LSB"))
    for gain in (1.0, 2.0, 3.0, 4.0):
        m = dataclasses.replace(PROTOTYPE, gain=gain)
        # σ_E in LSB grows sublinearly with gain; in analog units it shrinks
        sigma_analog = m.sigma_e_lsb() * m.adc_lsb()
        out.append(row(f"fig18_gain{gain:g}",
                       (time.perf_counter() - t0) * 1e6,
                       f"sigma_e_lsb={m.sigma_e_lsb():.3f}|"
                       f"sigma_analog={sigma_analog:.1f}"))
    # process variation: INL spread across 8 groups × 5 chips (seeded curves)
    frac = linspace0(1.0, 256, dev)
    spans = [float(torch.max(torch.abs(inl_curve_eager(
        frac, PROTOTYPE.inl_amp_lsb, seed=chip * 8 + grp))))
        for chip in range(5) for grp in range(8)]
    out.append(row("fig18_process_inl_spread",
                   (time.perf_counter() - t0) * 1e6,
                   f"inl_best={min(spans):.2f}|inl_worst={max(spans):.2f}|"
                   f"delta={max(spans) - min(spans):.2f}LSB"))
    return out


if __name__ == "__main__":
    run()
