"""Render the §Perf hillclimb log from experiments/perf/*.json (the
cells launch/perf.py writes).

    PYTHONPATH=src python -m repro_torch.analysis.perf_report
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .report import _rl


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/perf")
    args = ap.parse_args()
    rows = ["| var | cell | hypothesis | dom | t_comp | t_mem | t_coll |"
            " temp GiB | roofline frac | verdict |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    by_cell = {}
    for f in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        c = json.load(open(f))
        vid = c.get("variant", os.path.basename(f)[:-5])
        by_cell.setdefault(vid[0], []).append((vid, c))
    for group in sorted(by_cell):
        base = None
        for vid, c in sorted(by_cell[group]):
            if c["status"] != "ok":
                rows.append(f"| {vid} | {c['arch']}×{c['shape']} |"
                            f" {c.get('hypothesis', '')[:60]} | ERROR |"
                            f" | | | | | {c.get('error', '')[:60]} |")
                continue
            rl = _rl(c)
            temp = c["memory_analysis"].get("temp_size_in_bytes", 0) / 2**30
            terms = {"compute": rl.t_compute, "memory": rl.t_memory,
                     "collective": rl.t_collective}
            if base is None:
                base = (terms, temp, rl.roofline_fraction)
                verdict = "baseline"
            else:
                dom0 = max(base[0], key=base[0].get)
                delta = terms[dom0] / base[0][dom0] - 1
                verdict = (f"{dom0} {delta * 100:+.0f}% vs base; "
                           f"frac {base[2]:.3f}→{rl.roofline_fraction:.3f}")
            rows.append(
                f"| {vid} | {c['arch']}×{c['shape']} |"
                f" {c.get('hypothesis', '')[:70]} | {rl.dominant} |"
                f" {rl.t_compute:.3f} | {rl.t_memory:.3f} |"
                f" {rl.t_collective:.3f} | {temp:.1f} |"
                f" {rl.roofline_fraction:.4f} | {verdict} |")
    print("\n".join(rows))


if __name__ == "__main__":
    main()
