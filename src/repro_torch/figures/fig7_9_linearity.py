"""Fig. 7 (shift-and-add linearity, weight sweep) and Fig. 9 (end-to-end
input-sweep linearity). Paper: R² = 0.9999 for both.

Fig. 7 protocol: same input everywhere, sweep the stored 4-bit weight value;
output must be linear in the weight code.
Fig. 9 protocol: all-ones weights, sweep the DAC input code.
Both run `bp_mvm` at FULL with no key: the INL curve, no noise.
"""
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import PROTOTYPE
from repro_torch.core.macro import SimLevel
from repro_torch.core.schemes import bp_mvm
from repro_torch.device import resolve_device

from .common import row


def _r2(x, y):
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    a, b = np.polyfit(x, y, 1)
    resid = y - (a * x + b)
    return 1.0 - resid.var() / y.var()


def _mvm(xcode: float, wcode: float, macro, dev) -> float:
    """bp_mvm of one 144-row column, every input xcode and weight wcode."""
    x = torch.full((1, 144), xcode, device=dev)
    w = torch.full((144, 1), wcode, device=dev)
    return float(bp_mvm(x, w, macro)[0, 0])


def run(device=None):
    dev = resolve_device(device)
    out = []
    t0 = time.perf_counter()
    macro = dataclasses.replace(PROTOTYPE, sim_level=SimLevel.FULL)

    # Fig. 7: weight sweep at fixed input
    ys = [_mvm(9.0, float(wcode), macro, dev) for wcode in range(16)]
    r2_w = _r2(np.arange(16), ys)
    out.append(row("fig7_shiftadd_weight_sweep",
                   (time.perf_counter() - t0) * 1e6, f"R2={r2_w:.6f}"))

    # Fig. 9: input sweep with all-ones-equivalent weights (max code 15)
    outs = [_mvm(float(xcode), 15.0, macro, dev) for xcode in range(16)]
    r2_x = _r2(np.arange(16), outs)
    out.append(row("fig9_end_to_end_input_sweep",
                   (time.perf_counter() - t0) * 1e6, f"R2={r2_x:.6f}"))
    return out


if __name__ == "__main__":
    run()
