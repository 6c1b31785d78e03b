"""Fig. 15: end-to-end transfer curves at gain 1–4 with DNL/INL;
Fig. 17: transfer-curve slope (gain) vs stored weight code.

Paper: DNL +0.56/−0.41 LSB, INL ±1.10 LSB at gain 1; slope steps consistent
across the 16 weight codes. Both run the converter at FULL with no key: the
INL curve, no noise.
"""
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import PROTOTYPE
from repro_torch.core.adc import adc_quantize
from repro_torch.core.macro import SimLevel
from repro_torch.core.schemes import bp_mvm
from repro_torch.device import resolve_device

from .common import inl_curve_eager, linspace0, row


def transfer_codes(macro, n_points: int, device) -> np.ndarray:
    """Output codes (no dequant) of an n_points sweep of the analog input
    range [0, FS/gain]."""
    v = linspace0(macro.full_scale() / macro.gain, n_points, device)
    return adc_quantize(v, macro, dequantize=False).cpu().numpy()


def weight_slopes(macro, device) -> list[float]:
    """Slope of output vs input code (codes 2 → 14) per stored weight
    code 0..15, from bp_mvm of one 144-row column."""
    slopes = []
    for wcode in range(16):
        w = torch.full((144, 1), float(wcode), device=device)
        ys = [float(bp_mvm(torch.full((1, 144), float(xc), device=device),
                           w, macro)[0, 0]) for xc in (2, 6, 10, 14)]
        slopes.append((ys[-1] - ys[0]) / 12.0)
    return slopes


def run(device=None):
    dev = resolve_device(device)
    out = []
    t0 = time.perf_counter()
    for gain in (1.0, 2.0, 3.0, 4.0):
        macro = dataclasses.replace(PROTOTYPE, gain=gain,
                                    sim_level=SimLevel.FULL)
        # DNL/INL from the code-edge positions of a fine input sweep
        codes = transfer_codes(macro, 1 << 15, dev)
        edges = np.searchsorted(codes, np.arange(1, macro.adc_levels))
        widths = np.diff(edges).astype(np.float64)
        lsb_samples = widths.mean()
        dnl = widths / lsb_samples - 1.0
        inl = np.cumsum(dnl)
        # raw (absolute-scale) INL of the model curve — the paper's ±1.10
        # bound is on this; the edge-fitted INL removes the endpoint line
        raw = inl_curve_eager(linspace0(1.0, 1024, dev), macro.inl_amp_lsb,
                              0).cpu().numpy()
        out.append(row(f"fig15_gain{gain:g}",
                       (time.perf_counter() - t0) * 1e6,
                       f"DNL=[{dnl.min():+.2f},{dnl.max():+.2f}]LSB|"
                       f"INLfit=[{inl.min():+.2f},{inl.max():+.2f}]LSB|"
                       f"INLraw=[{raw.min():+.2f},{raw.max():+.2f}]LSB"))

    # Fig. 17: slope of output-vs-input-code per stored weight code
    macro = dataclasses.replace(PROTOTYPE, sim_level=SimLevel.FULL)
    steps = np.diff(weight_slopes(macro, dev))
    out.append(row("fig17_weight_gain_steps",
                   (time.perf_counter() - t0) * 1e6,
                   f"step_mean={steps.mean():.1f}|step_std={steps.std():.2f}|"
                   f"worst_code={int(np.argmax(np.abs(steps - steps.mean())) + 1)}"))
    return out


if __name__ == "__main__":
    run()
