"""Time the expert-batched MVMs B1e / B6e and B2e / B5e, and the kernels
that share their source (B1 / B6 at the decode step), for the `repro_torch`
package of a given source tree, so that two trees can be compared on one
card in one run (run them in turn: first, second, second, first):

    python tools/moe_mvm_timing.py --src build/parent/src --label parent
    python tools/moe_mvm_timing.py --src src --label change

`--build-only` compiles the tree's MVM library and exits (start both trees'
builds together before the timed runs); `--groups` picks the rows below
(default all). Prints one JSON line: the label, the card's name and power
limit, and µs per call on the card (CUDA-graph replays, cycling through
weight copies larger than L2, median of 5) of
  * moe: B1e and B6e (NOISY, seed 0) at `chip_smoke.py` phase 3m's shapes:
    qwen2-moe-a2.7b's 64 padded experts of capacity 8, K 2048 -> N 1408
    (e_gate, e_up) and K 1408 -> N 2048 (e_down), each projection and the
    layer's three; then rank 0's expert slice at ep 2, 4 and 8;
  * ep: B2e and B5e at the same shapes and slices (f32 codes);
  * c40: B2e and B5e at qwen2-moe's training capacity (phase 3y (0): 40
    rows an expert at 2 x 256 tokens), each projection and the layer's
    three;
  * decode: B1, B6, B2 and B5 over internlm2-1.8b's 169 decode-step MVMs
    (M = 4; packed codes for B1 / B6, f32 codes for B2 / B5);
  * deepseek: B2e and B5e over one deepseek-v3 layer's three expert MVMs
    (256 experts of capacity 8, K 7168 <-> 2048; f32 codes, 15 GB a
    matrix).
B2e / B5e state the codes' width (`code_bits` 4) where the tree's wrappers
take it. Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import inspect
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
    ap.add_argument("--groups", default="moe,ep,c40,decode,deepseek",
                    help="comma-separated rows to time")
    args = ap.parse_args()
    groups = set(args.groups.split(","))
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("moe_mvm_timing: needs a CUDA device", file=sys.stderr)
        return 2
    # the tree's package first: chip_smoke (imported for its timing helpers
    # and shapes) puts this repository's src in front of sys.path
    import repro_torch
    if not pathlib.Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch imported from {repro_torch.__file__}"
                           f", not from {src}")
    from repro_torch.core.adc import stochastic_transfer_params
    from repro_torch.core.macro import MacroConfig, SimLevel
    from repro_torch.kernels import build
    from repro_torch.kernels import cim_mvm as cm
    from repro_torch.kernels import ops
    sys.path.insert(1, str(ROOT))
    from chip_smoke import (DECODE_MVMS, DS_CAPACITY, DS_EXPERTS, DS_MVMS,
                            EP_RANKS, MOE_CAPACITY, MOE_EXPERTS, MOE_MVMS,
                            Y_BATCH, Y_SEQ, copies, graph_ms)
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import moe
    build.build_all(["cim_mvm"])
    if args.build_only:
        return 0
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def codes(shape):
        if np.prod(shape) > 1 << 28:      # deepseek's matrices: on the card
            gen = torch.Generator(dev).manual_seed(int(np.prod(shape)))
            return torch.empty(shape, device=dev).random_(0, 16,
                                                          generator=gen)
        return torch.from_numpy(rng.integers(0, 16, size=shape,
                                             dtype=np.uint8)).to(dev).float()

    kw = dict(n_rows=144, levels=362, gain=1.0, full_scale=32400.0)
    st = stochastic_transfer_params(MacroConfig(sim_level=SimLevel.NOISY))
    nkw = dict(kw, sigma=st["sigma"], inl_amp=st["inl_amp"],
               apply_inl=st["apply_inl"])
    seed = torch.tensor([0], dtype=torch.int32, device=dev)

    def time_us(fn, x, w):
        return 1e3 * graph_ms(torch, fn, [(x, wi) for wi in copies(w)])

    out = {"label": args.label}

    def expert_rows(tag, pairs, cap, packed, slices):
        """Each pair at qwen2-moe's expert shapes of capacity `cap`: each
        projection, the layer's three and (`slices`) rank 0's slice."""
        for name, k, n, count in MOE_MVMS:
            x = codes((MOE_EXPERTS, cap, k))
            w = codes((MOE_EXPERTS, k, n))
            if packed:
                w = ops.pack_codes(w).contiguous()
            for kid, fn in pairs:
                t = time_us(fn, x, w)
                out[f"{kid}{tag}_{name}_us"] = t
                key = f"{kid}{tag}_layer_us"
                out[key] = out.get(key, 0.0) + count * t
                for ep in EP_RANKS if slices else ():
                    el = MOE_EXPERTS // ep
                    t = time_us(fn, x[:el].contiguous(), w[:el].contiguous())
                    key = f"{kid}_ep{ep}_layer_us"
                    out[key] = out.get(key, 0.0) + count * t
            del x, w
            torch.cuda.empty_cache()

    # the codes' width, where the tree's B2e / B5e wrappers take it
    bits = {"code_bits": 4} if "code_bits" in inspect.signature(
        cm.cim_mvm_grouped_experts).parameters else {}
    dense = (("B2e", lambda a, b: cm.cim_mvm_grouped_experts(
                  a, b, **kw, **bits)),
             ("B5e", lambda a, b: cm.cim_mvm_grouped_noisy_experts(
                  a, b, seed, **nkw, **bits)))
    if "moe" in groups:
        expert_rows("", (
            ("B1e", lambda a, b: cm.cim_mvm_grouped_packed_experts(
                a, b, **kw)),
            ("B6e", lambda a, b: cm.cim_mvm_grouped_noisy_packed_experts(
                a, b, seed, **nkw))), MOE_CAPACITY, True, True)
    if "ep" in groups:
        expert_rows("_c8", dense, MOE_CAPACITY, False, True)
    if "c40" in groups:
        cap = moe._capacity(Y_BATCH * Y_SEQ, ARCHS["qwen2-moe-a2.7b"])
        out["c40_capacity"] = cap
        expert_rows("_c40", dense, cap, False, False)
    if "decode" in groups:
        packed = (("B1", lambda a, b: cm.cim_mvm_grouped_packed(a, b, **kw)),
                  ("B6", lambda a, b: cm.cim_mvm_grouped_noisy_packed(
                      a, b, seed, **nkw)))
        flat = (("B2", lambda a, b: cm.cim_mvm_grouped(a, b, **kw)),
                ("B5", lambda a, b: cm.cim_mvm_grouped_noisy(
                    a, b, seed, **nkw)))
        for name, k, n, count in DECODE_MVMS:
            x = codes((4, k))
            w = codes((k, n))
            for pairs, wk in ((packed, ops.pack_codes(w).contiguous()),
                              (flat, w)):
                for kid, fn in pairs:
                    key = f"{kid}_step_us"
                    out[key] = out.get(key, 0.0) + count * time_us(fn, x, wk)
            del x, w
    if "deepseek" in groups:
        for name, k, n, count in DS_MVMS:
            x = codes((DS_EXPERTS, DS_CAPACITY, k))
            w = codes((DS_EXPERTS, k, n))
            for kid, fn in dense:
                key = f"{kid}_layer_us"
                out[key] = out.get(key, 0.0) + count * time_us(fn, x, w)
            del x, w
            torch.cuda.empty_cache()
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        env=dict(os.environ)).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
