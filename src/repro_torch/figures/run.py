"""The paper's figures and Table I: one module per figure.

Prints ``name,us_per_call,derived`` CSV rows, the reference's figure rows
(its `benchmarks.run` without the kernel bench). Runs on the card unless
given --device cpu:
    PYTHONPATH=src python -m repro_torch.figures.run [--only fig2] \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import traceback

from . import (fig1b_schemes, fig2_sqnr, fig7_9_linearity, fig10_adc_bits,
               fig15_17_transfer, fig16_noise, fig18_pvt, fig19_inference,
               fig21_energy, table1_summary)

MODULES = [
    ("fig1b", fig1b_schemes), ("fig2", fig2_sqnr), ("fig7_9", fig7_9_linearity),
    ("fig10", fig10_adc_bits), ("fig15_17", fig15_17_transfer),
    ("fig16", fig16_noise), ("fig18", fig18_pvt), ("fig19", fig19_inference),
    ("fig21", fig21_energy), ("table1", table1_summary),
]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="substring filter on the figure name")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    failures = 0
    for name, mod in MODULES:
        if args.only and args.only not in name:
            continue
        try:
            mod.run(device=args.device)
        except Exception:
            failures += 1
            print(f"{name},nan,ERROR", flush=True)
            traceback.print_exc()
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
