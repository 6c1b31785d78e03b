"""§Perf hillclimb: trace named variants of the three chosen cells
through the port's dry-run (launch/dryrun.py), measure the roofline terms
(per-layer extrapolated exact costs, on the H100's data-sheet peaks) and
dump JSON.

    PYTHONPATH=src python -m repro_torch.launch.perf --cell A1 [--out experiments/perf]

Cells and variants are the reference's (its TPU plan chose them; the
hypotheses in VARIANTS are its, carried as text, not the port's numbers):
  A — deepseek-v3-671b × train_4k
  B — llama3-8b × prefill_32k
  C — llama3-8b × decode_32k        (the paper's technique: 4-bit CIM serving)
"""
import argparse
import dataclasses
import json
import os

from repro_torch.configs.registry import ARCHS
from repro_torch.launch.dryrun import run_cell


def _ds(**kw):
    cfg = ARCHS["deepseek-v3-671b"]
    moe_kw = {k: v for k, v in kw.items() if k in ("ep_mode",
                                                   "capacity_factor")}
    other = {k: v for k, v in kw.items() if k not in moe_kw}
    if moe_kw:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    return cfg.replace(**other) if other else cfg


def _ll(**kw):
    return ARCHS["llama3-8b"].replace(**kw) if kw else ARCHS["llama3-8b"]


# variant table: id → (arch, shape, cim, cfg_override, hypothesis)
VARIANTS = {
    # --- cell A: deepseek train (dominant term: memory; 176 GiB/chip) ----
    "A0": ("deepseek-v3-671b", "train_4k", "off", None,
           "baseline (psum-EP, dots-remat)"),
    "A1": ("deepseek-v3-671b", "train_4k", "off", _ds(ep_mode="a2a"),
           "a2a EP: seq-sharded dispatch — buffers /16, psum(T·D) → 2×a2a "
           "of routed tokens only; predict temp −60 %+, collective −30 %"),
    "A2": ("deepseek-v3-671b", "train_4k", "off",
           _ds(ep_mode="a2a", remat_policy="nothing"),
           "+ full remat: stop saving dot outputs inside MoE layers; "
           "predict temp −40 % more, compute +~25 % (recompute)"),
    "A4": ("deepseek-v3-671b", "train_4k", "off",
           _ds(ep_mode="a2a", remat_policy="nothing", ce_chunks=8),
           "+ chunked cross-entropy (8 seq chunks, remat'd): the [65k, 8k] "
           "per-chip logits (fwd+bwd f32) never fully materialize; predict "
           "temp −4–6 GiB, other terms ≈ flat"),
    # --- cell B: llama3 prefill (dominant term: collective, AR-heavy) ----
    "B0": ("llama3-8b", "prefill_32k", "off", None,
           "baseline (GSPMD picks ring all-reduce for TP outputs)"),
    "B1": ("llama3-8b", "prefill_32k", "off", _ll(tp_reduce_scatter=True),
           "explicit psum_scatter on wo/w_down: AR(2×) → RS(1×); predict "
           "wire bytes −~45 %"),
    "B2": ("llama3-8b", "prefill_32k", "off",
           _ll(tp_reduce_scatter=True, attn_triangular_max=32),
           "+ triangular q-chunk unroll at nq=32: skip fully-masked causal "
           "blocks; predict attention FLOPs −~2×, t_comp −30 %"),
    # --- iteration 2 -------------------------------------------------------
    "A3": ("deepseek-v3-671b", "train_4k", "off",
           _ds(ep_mode="a2a", remat_policy="nothing"),
           "+ gradient-accumulation microbatch=8: live activations /8; "
           "predict temp −50 %+, collective ≈ flat (weight gathers ×8 "
           "amortized by remat recompute already)", {"microbatch": 32}),
    "B3": ("llama3-8b", "prefill_32k", "off",
           _ll(tp_reduce_scatter=True, attn_triangular_max=32),
           "serving topology: params TP-only (replicated over data, no "
           "FSDP) — inference has no optimizer state; predict all-gather "
           "bytes −80 %+", {"fsdp_off": True}),
    # --- cell C: the paper's technique — 4-bit CIM serving ---------------
    "C0": ("llama3-8b", "decode_32k", "off", None,
           "float bf16 decode baseline"),
    "C1": ("llama3-8b", "decode_32k", "bp", None,
           "paper-faithful BP CIM decode (quantize-on-the-fly from bf16): "
           "adds quant ops; memory term ≈ baseline (still reads bf16 W)"),
    "C2": ("llama3-8b", "decode_32k", "bp-prequant", None,
           "offline-quantized stored codes, nibble-packed uint8 (two u4 "
           "per byte, the SRAM-density format): weight bytes /4 vs bf16; "
           "predict memory term −~60 %"),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", action="append", default=None,
                    help="variant id (A0..C2); repeatable; default all")
    ap.add_argument("--out", default="experiments/perf")
    args = ap.parse_args()
    ids = args.cell or sorted(VARIANTS)
    for vid in ids:
        spec = VARIANTS[vid]
        arch, shape, cim, cfg_override, hyp = spec[:5]
        extra = spec[5] if len(spec) > 5 else {}
        from repro_torch.launch import dryrun as dr
        from repro_torch.parallel import sharding as sh
        dr.TC_OVERRIDES = {k: v for k, v in extra.items()
                           if k == "microbatch"}
        if extra.get("fsdp_off"):
            sh.set_fsdp(False)
        try:
            r = run_cell(arch, shape, "single", cim=cim, out_dir=None,
                         analysis="extrapolate", cfg_override=cfg_override)
        finally:
            sh.set_fsdp(True)
            dr.TC_OVERRIDES = {}
        r["variant"] = vid
        r["hypothesis"] = hyp
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"{vid}.json"), "w") as f:
            json.dump(r, f, indent=1)
        if r["status"] == "ok":
            rl = r["roofline"]
            print(f"[{vid}] dom={rl['dominant']} frac={rl['roofline_fraction']:.4f}"
                  f" tC={rl['t_compute_s']:.3f} tM={rl['t_memory_s']:.3f}"
                  f" tX={rl['t_collective_s']:.3f}"
                  f" temp={r['memory_analysis']['temp_size_in_bytes'] / 2**30:.1f}GiB",
                  flush=True)
        else:
            print(f"[{vid}] {r['status']}: {r.get('error', '')[:200]}",
                  flush=True)


if __name__ == "__main__":
    main()
