"""Reproduce the paper's §II-A SQNR study (Fig. 2) from the command line.

    PYTHONPATH=src python -m repro_torch.examples.sqnr_study [--device cpu]

Runs on the card unless given --device cpu.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.core import PROTOTYPE, Scheme
from repro_torch.core.sqnr import simulate_sqnr
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    print("Fig. 2(b): N=144, iso-energy configs (levels 1024/256/32)")
    vals = {}
    for scheme, levels in ((Scheme.BP, 1024), (Scheme.WBS, 256),
                           (Scheme.BS, 32)):
        cfg = dataclasses.replace(PROTOTYPE, scheme=scheme, adc_levels=levels)
        r = simulate_sqnr(cfg, k=144, n_samples=1 << 14, device=dev)
        vals[scheme] = r
        print(f"  {scheme.value:3s} levels={levels:5d}: {r.sqnr_db:6.2f} dB  "
              f"E={r.energy_per_mvm_j * 1e12:6.2f} pJ")
    print(f"  BP−WBS = {vals[Scheme.BP].sqnr_db - vals[Scheme.WBS].sqnr_db:.1f}"
          f" dB (paper: 7.8) | BP−BS = "
          f"{vals[Scheme.BP].sqnr_db - vals[Scheme.BS].sqnr_db:.1f} dB "
          "(paper: 21.6)")

    print("\nFig. 2(a): levels=64, iso-energy N (9/36/144)")
    for scheme, n in ((Scheme.BP, 9), (Scheme.WBS, 36), (Scheme.BS, 144)):
        cfg = dataclasses.replace(PROTOTYPE, scheme=scheme, n_rows=n,
                                  adc_levels=64)
        r = simulate_sqnr(cfg, k=144, n_samples=1 << 14, device=dev)
        print(f"  {scheme.value:3s} N={n:3d}: {r.sqnr_db:6.2f} dB")


if __name__ == "__main__":
    main()
