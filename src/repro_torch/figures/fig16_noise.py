"""Fig. 16: (a) RMS σ of output codes under thermal noise (≈0.4 LSB across 8
MVM groups); (b) total computing-error distribution σ_E ≈ 0.59 LSB.

Each conversion sweep draws its noise from its own torch.Generator, seeded
where the reference folds its key: grp·100 + r in (a), 999 + r in (b). The
draws differ from jax.random's, so the σ agree with the reference's in
distribution.
"""
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import PROTOTYPE
from repro_torch.core.adc import adc_quantize
from repro_torch.core.macro import SimLevel
from repro_torch.device import resolve_device

from .common import linspace0, row

REPEATS = 50  # paper: each code repeated 50 times


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def run(device=None):
    dev = resolve_device(device)
    out = []
    t0 = time.perf_counter()
    v = linspace0(PROTOTYPE.full_scale(), 256, dev)

    # (a) thermal-only σ per MVM group (different INL seeds = groups)
    sigmas = []
    macro = dataclasses.replace(PROTOTYPE, sim_level=SimLevel.NOISY)
    for grp in range(8):
        codes = torch.stack([
            adc_quantize(v, macro, key=_gen(grp * 100 + r, dev),
                         inl_seed=grp, dequantize=False)
            for r in range(REPEATS)])
        sigmas.append(float(torch.mean(torch.std(codes, dim=0,
                                                 correction=0))))
    out.append(row("fig16a_thermal_sigma", (time.perf_counter() - t0) * 1e6,
                   f"rms_sigma_lsb={np.mean(sigmas):.3f}|"
                   f"per_group=[{min(sigmas):.3f},{max(sigmas):.3f}]"))

    # (b) total error distribution (noise + INL) vs ideal transfer
    macro_full = dataclasses.replace(PROTOTYPE, sim_level=SimLevel.FULL)
    ideal = adc_quantize(v, PROTOTYPE, dequantize=False)
    errs = []
    for r in range(REPEATS):
        c = adc_quantize(v, macro_full, key=_gen(999 + r, dev),
                         dequantize=False)
        errs.append((c - ideal).cpu().numpy())
    sigma_e = float(np.std(np.stack(errs)))
    out.append(row("fig16b_total_sigma_e", (time.perf_counter() - t0) * 1e6,
                   f"sigma_e_lsb={sigma_e:.3f}|model={macro_full.sigma_e_lsb():.3f}"))
    return out


if __name__ == "__main__":
    run()
