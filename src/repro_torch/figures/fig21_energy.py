"""Fig. 21: energy efficiency and clock frequency over 0.65–1.2 V, plus the
DAC's sparsity-dependent energy share (paper: 2.4–14.6 %).

The sparsity rows' 4096 input codes and mask are drawn with numpy
RandomState(0) (the reference draws them with jax.random).
"""
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import PROTOTYPE
from repro_torch.core.dac import dac_energy_j
from repro_torch.core.energy import macro_throughput_gops, mvm_energy
from repro_torch.core.macro import OperatingPoint
from repro_torch.device import resolve_device

from .common import row


def sparse_codes(sparsity: float) -> np.ndarray:
    """4096 u4 input codes, each zeroed with probability `sparsity` (the
    same codes and uniforms for every sparsity), f32."""
    rng = np.random.RandomState(0)
    codes = rng.randint(0, 16, 4096).astype(np.float32)
    mask = rng.uniform(size=4096) >= sparsity
    return codes * mask


def run(device=None):
    dev = resolve_device(device)
    out = []
    t0 = time.perf_counter()
    for vdd in (0.65, 0.75, 0.9, 1.05, 1.2):
        m = dataclasses.replace(PROTOTYPE, op=OperatingPoint(vdd=vdd))
        rep = mvm_energy(m, 144)
        out.append(row(f"fig21_vdd{vdd:g}", (time.perf_counter() - t0) * 1e6,
                       f"TOPSW={rep.tops_per_w:.1f}|"
                       f"fclk_MHz={m.clock_hz() / 1e6:.1f}|"
                       f"GOPS={macro_throughput_gops(m):.1f}"))

    # DAC energy share across input sparsity (zero codes charge nothing)
    for sparsity in (0.0, 0.5, 0.9):
        codes = torch.from_numpy(sparse_codes(sparsity)).to(dev)
        e_dac = float(dac_energy_j(codes, PROTOTYPE))  # one group conversion
        e_tot = mvm_energy(PROTOTYPE, 144).e_mvm_j
        share = e_dac / (e_tot + e_dac)
        out.append(row(f"fig21_dac_sparsity{sparsity:g}",
                       (time.perf_counter() - t0) * 1e6,
                       f"dac_share={share * 100:.1f}%"))
    return out


if __name__ == "__main__":
    run()
