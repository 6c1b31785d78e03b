"""The §Dry-run / §Roofline tables from the JSON cells that
launch/dryrun.py writes (the port's cells: roofline terms on the H100's
data-sheet peaks). Memory is held against the card's 80 GiB only on a
one-chip mesh: on a planned mesh the temp bytes are rank 0's program's,
whose tensors the port keeps whole, not the plan's share, and the note
names that program instead (`launch.dryrun`'s "program").

    PYTHONPATH=src python -m repro_torch.analysis.report --dir experiments/dryrun
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .roofline import HBM_BYTES, Roofline


def _rl(c: dict) -> Roofline:
    """Rebuild the Roofline from raw stored fields (so metric refinements —
    e.g. the 2× all-reduce wire weighting — apply to old artifacts too)."""
    r = c["roofline"]
    return Roofline(
        arch=c["arch"], shape=c["shape"], mesh=c["mesh"], chips=r["chips"],
        hlo_flops=r["hlo_flops"], hlo_bytes=r["hlo_bytes"],
        collective_bytes=r["collective_bytes"],
        model_flops=r["model_flops"],
        peak_bytes_per_chip=r.get("peak_bytes_per_chip", 0.0),
        collective_detail=r.get("collective_detail", {}),
        work_chips=r.get("work_chips"))


def _fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.2f}"


def _fmt_flops(f: float) -> str:
    return f"{f / 1e12:.2f}"


def load_cells(d: str) -> list[dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def roofline_table(cells: list[dict], *, mesh: str = "pod16x16",
                   xp_only: bool = True) -> str:
    rows = ["| arch | shape | dom. | t_comp (s) | t_mem (s) | t_coll (s) | "
            "useful | roofline frac | HLO TFLOP/chip | mem GiB/chip | note |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c["mesh"] != mesh or c.get("cim", "off") != "off":
            continue
        is_xp = c["cell"].endswith("__xp")
        if xp_only != is_xp:
            continue
        if c["status"] == "skipped":
            rows.append(f"| {c['arch']} | {c['shape']} | — | — | — | — | — |"
                        f" — | — | — | {c['reason'][:60]} |")
            continue
        if c["status"] != "ok":
            rows.append(f"| {c['arch']} | {c['shape']} | ERROR | | | | | | |"
                        f" | {c['error'][:60]} |")
            continue
        rl = _rl(c)
        mem = c["memory_analysis"].get("temp_size_in_bytes", 0)
        note = ""
        if rl.chips > 1:
            note = c.get("program", "")
        elif mem > HBM_BYTES:
            note = "over 80 GiB HBM — see §Perf"
        rows.append(
            f"| {c['arch']} | {c['shape']} | {rl.dominant} |"
            f" {rl.t_compute:.3f} | {rl.t_memory:.3f} |"
            f" {rl.t_collective:.3f} | {rl.useful_ratio:.2f} |"
            f" {rl.roofline_fraction:.3f} | {_fmt_flops(rl.hlo_flops)} |"
            f" {_fmt_bytes(mem)} | {note} |")
    return "\n".join(rows)


def dryrun_table(cells: list[dict]) -> str:
    rows = ["| arch | shape | mesh | status | compile (s) | temp GiB/chip | "
            "args GiB/chip | collective bytes/chip | AR/AG/RS/A2A/CP counts |",
            "|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c["cell"].endswith("__xp") or c.get("cim", "off") != "off":
            continue
        if c["status"] == "skipped":
            rows.append(f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                        f"skipped | | | | | {c['reason'][:50]} |")
            continue
        if c["status"] != "ok":
            rows.append(f"| {c['arch']} | {c['shape']} | {c['mesh']} | ERROR"
                        f" | | | | | {c['error'][:50]} |")
            continue
        m = c["memory_analysis"]
        det = c["roofline"]["collective_detail"]
        counts = det.get("counts", {})
        cstr = "/".join(str(counts.get(k, 0)) for k in
                        ("all-reduce", "all-gather", "reduce-scatter",
                         "all-to-all", "collective-permute"))
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | ok |"
            f" {c['compile_s']} | {_fmt_bytes(m.get('temp_size_in_bytes', 0))} |"
            f" {_fmt_bytes(m.get('argument_size_in_bytes', 0))} |"
            f" {c['roofline']['collective_bytes']:.3g} | {cstr} |")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="pod16x16")
    args = ap.parse_args()
    cells = load_cells(args.dir)
    print("## §Roofline (single-pod, unrolled-extrapolated exact costs)\n")
    print(roofline_table(cells, mesh=args.mesh))
    print("\n## §Dry-run (traced steps — trace proof + memory)\n")
    print(dryrun_table(cells))


if __name__ == "__main__":
    main()
