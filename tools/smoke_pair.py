"""Run `chip_smoke.py` of several source trees in turn on one card, each
line of its output stamped with the seconds since that tree's run
started, so that two commits can be compared phase by phase in one run:

    git archive HEAD | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    python3 tools/smoke_pair.py build/change build/parent [--out DIR]

Each tree's output goes to `DIR/smoke_<dir name>.log` (standard error to
`.err`; DIR defaults to experiments/smoke_pair); a tree whose script
fails stops the list. For each tree one JSON line: its exit code, its
seconds and those of every phase, from the first line of a phase
("phase <name>", a name differing from the line before's) to the next
phase's first line, summed where a phase's lines come back; "start" is
everything before the first phase line (the kernels' build).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import time


def run(tree: pathlib.Path, out_dir: pathlib.Path
        ) -> tuple[int, float, pathlib.Path]:
    log = out_dir / f"smoke_{tree.name}.log"
    t0 = time.monotonic()
    with open(log, "w") as out, open(log.with_suffix(".err"), "w") as err:
        proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"],
                                cwd=tree, stdout=subprocess.PIPE,
                                stderr=err, text=True)
        for line in proc.stdout:
            out.write(f"{time.monotonic() - t0:9.1f} {line}")
            out.flush()
        rc = proc.wait()
    return rc, time.monotonic() - t0, log


def phase_seconds(log: pathlib.Path) -> dict:
    secs, phase, at, end = {}, "start", 0.0, 0.0
    for line in open(log, errors="replace"):
        m = re.match(r"\s*([0-9.]+) (.*)", line)
        if not m:
            continue
        end = float(m.group(1))
        p = re.match(r"phase (\w+)", m.group(2))
        if p and p.group(1) != phase:
            secs[phase] = round(secs.get(phase, 0.0) + end - at, 1)
            phase, at = p.group(1), end
    secs[phase] = round(secs.get(phase, 0.0) + end - at, 1)
    return secs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("experiments/smoke_pair"))
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    rc_all = 0
    for tree in args.trees:
        rc, secs, log = run(tree.resolve(), args.out.resolve())
        print(json.dumps({"tree": str(tree), "rc": rc,
                          "seconds": round(secs, 1),
                          "phases": phase_seconds(log)}), flush=True)
        if rc:
            rc_all = rc
            break
    return rc_all


if __name__ == "__main__":
    sys.exit(main())
