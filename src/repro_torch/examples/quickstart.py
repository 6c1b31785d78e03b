"""Quickstart: the PICO-RAM macro as a PyTorch matmul.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on the card unless given --device cpu (the kernels' plain versions).
The inputs are drawn with numpy RandomState(0).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import CIMConfig, PROTOTYPE, Scheme, cim_matmul
from repro_torch.core.energy import mvm_energy
from repro_torch.core.sqnr import simulate_sqnr
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import cim_mvm_dense


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.RandomState(0)

    # --- 1. a float matmul on the simulated analog macro --------------------
    x = torch.from_numpy(np.maximum(rng.standard_normal((8, 288)), 0.0)
                         .astype(np.float32)).to(dev)   # activations ≥ 0
    w = torch.from_numpy((rng.standard_normal((288, 16)) * 0.1)
                         .astype(np.float32)).to(dev)

    y_float = x @ w
    for gain in (1.0, 3.0):
        cim = CIMConfig(enabled=True,
                        macro=dataclasses.replace(PROTOTYPE, gain=gain))
        y_cim = cim_matmul(x, w, cim)
        rel = float(torch.linalg.norm(y_cim - y_float)
                    / torch.linalg.norm(y_float))
        print(f"BP 4b×4b @8.5-bit ADC, gain={gain:g}: rel err "
              f"{rel * 100:.2f}%")

    # --- 2. the schemes the paper compares against --------------------------
    print("\nscheme comparison (Eq. 4 energy / Monte-Carlo SQNR, K=144):")
    for scheme in (Scheme.BP, Scheme.WBS, Scheme.BS):
        macro = dataclasses.replace(PROTOTYPE, scheme=scheme)
        r = simulate_sqnr(macro, k=144, n_samples=1 << 12, device=dev)
        e = mvm_energy(macro, 144)
        print(f"  {scheme.value:3s}: SQNR {r.sqnr_db:5.1f} dB | "
              f"E_MVM {e.e_mvm_j * 1e12:6.2f} pJ | {e.tops_per_w:5.1f} TOPS/W")

    # --- 3. the fused Hopper kernel B2 (its plain version on the CPU) -------
    codes_x = torch.floor(x / (x.max() / 15.0))
    codes_w = torch.floor((w - w.min()) / ((w.max() - w.min()) / 15.0))
    y_kernel = cim_mvm_dense(codes_x, codes_w, PROTOTYPE)
    print(f"\nB2 kernel output: {tuple(y_kernel.shape)}, "
          f"finite={bool(torch.all(torch.isfinite(y_kernel)))}")
    print("done.")


if __name__ == "__main__":
    main()
