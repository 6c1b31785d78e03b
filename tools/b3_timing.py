"""Time the paged attention kernel B3 at `chip_smoke.py` phase 2's shapes
for the `repro_torch` package of a given source tree, so that two trees'
kernels can be compared on one card in one run (run them in turn:
first, second, second, first):

    python tools/b3_timing.py --src build/parent/src --label parent
    python tools/b3_timing.py --src src --label change

`--build-only` compiles the tree's B3 library and exits (start both trees'
builds together before the timed runs). Prints one JSON line: the label,
the card's name and power limit, and µs per call on the card (CUDA-graph
replays over pool copies larger than L2, median of 5) of B3 at decode (C
= 1, f32 q), at the prefill chunk (C = 16), the one-launch decode (B3 +
B4, bf16 q and output), and, where the tree's B3 reads a head slice of
the pools in place, B3 on rank 0's KV heads of 2 ranks at both shapes.
Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--label", default="")
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("b3_timing: needs a CUDA device", file=sys.stderr)
        return 2
    # the tree's package first: chip_smoke (imported for its timing helpers)
    # puts this repository's src in front of sys.path
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa
    from chip_smoke import copies, graph_ms
    build.build_all(["paged_attention"])
    if args.build_only:
        return 0
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    b, kh, g, dh, bs, mb = 4, 8, 2, 128, 16, 16
    nb = b * mb + 1
    pools = [torch.from_numpy(rng.standard_normal((nb, bs, kh, dh)).astype(
        np.float32)).to(dev).bfloat16() for _ in range(2)]
    for p in pools:
        p[0] = float("nan")
    lens = torch.tensor([0, 37, 130, 224], dtype=torch.int32, device=dev)
    tables = torch.from_numpy(rng.permutation(np.arange(1, nb)).astype(
        np.int32).reshape(b, mb)).to(dev)
    pc = list(zip(copies(pools[0]), copies(pools[1])))
    out = {"label": args.label}
    for c in (1, 16):
        kvl = lens + torch.tensor([0, c, c, c], dtype=torch.int32,
                                  device=dev)
        q = torch.from_numpy(rng.standard_normal((b, c, kh * g, dh)).astype(
            np.float32)).to(dev)
        tag = "decode" if c == 1 else "prefill"
        out[f"b3_{tag}_us"] = 1e3 * graph_ms(torch, lambda kp, vp: (
            pa.paged_attn_call(q, kp, vp, tables, lens, kvl)), pc)
        if hasattr(pa, "_pool_heads"):
            half = kh // 2
            qs = q[:, :, :half * g].contiguous()
            out[f"b3_{tag}_slice_us"] = 1e3 * graph_ms(
                torch, lambda kp, vp: pa.paged_attn_call(
                    qs, kp.narrow(2, 0, half), vp.narrow(2, 0, half),
                    tables, lens, kvl), pc)
        if c == 1:
            new = [torch.from_numpy(rng.standard_normal(
                (b, 1, kh, dh)).astype(np.float32)).to(dev).bfloat16()
                for _ in range(2)]
            flat = (tables[:, 2].long() * bs + 5).to(torch.int32)
            flat[0] = 0
            qb = q.bfloat16()
            out["decode_launch_us"] = 1e3 * graph_ms(
                torch, lambda kp, vp: pa.decode_write_attend_call(
                    qb, kp, vp, *new, flat, tables, lens, kvl,
                    out_dtype=torch.bfloat16), pc)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        env=dict(os.environ)).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
