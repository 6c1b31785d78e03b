#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA device. It imports
only the port (`src/repro_torch`), never JAX or the JAX package, and exits
non-zero without a CUDA device or without the port beside it. Phases, each
of which fails the run when it fails:

  1. the card's name and power limit (nvidia-smi); build the Hopper kernels
     B1-B6 (one nvcc per source, started together) and time the build;
  2. each kernel against its plain PyTorch version on the card at the main
     path's shapes, from numpy-seeded inputs: B1/B2 (grouped ADC MVM,
     packed/dense) bit-exact at M in {4, 64} over the internlm2-1.8b layer
     and head widths; B5/B6 (the same with the seeded NOISY converter)
     bit-exact at the same shapes for seeds 0 and 7, B6 equal to B5, the
     inl_seed salt changing the draws, and FULL (INL curve) at one layer
     shape; B3 (paged flash attention) at decode C=1 and prefill C=16 with
     mixed lengths, an idle lane and a NaN trash block, bit-exact and
     finite; B4 (the decode K/V write), which runs inside B3's decode
     launch: that launch bit-exact against B4's plain version then B3's
     (outputs and both pools, f32 and bf16 q/output). Each is timed with
     CUDA events beside its plain version, a bound and, where one exists,
     a PyTorch library call (the MVM kernels over one decode step's 169
     MVMs and over a prefill chunk's 168 layer MVMs at M=64, logged per
     shape; B3 at decode and at the prefill chunk; B4 as the decode
     launch's time less B3's alone at the same shapes); B3 alone and the
     B3+B4 decode launch at the head dims and block sizes past the fast
     case (dh 16, 20, 56, 80, 128 x bs 16, 48, 64, 128; bf16 and f32 pools)
     bit-exact against their plain versions; B3 timed at decode at dh 80 /
     bs 16 and dh 128 / bs 64 and at a verify step (C = 5), and B1 over a
     verify step's MVMs (M = 20);
  3. full-width internlm2-1.8b (24 layers, d_model 2048, vocab 92544,
     random weights from a torch.Generator seed) served through `Server`
     with --cim bp-prequant and the kernel attention: 8 requests, two
     sharing a 32-token prefix. Launch counts are reset just before and
     read just after; B1, B3 (prefill) and the B3+B4 decode launch must
     each have launched. Then one prefill and one decode `paged_step`
     with the kernels and with their plain versions, which must give
     identical logits, and where one decode step's time goes (CUDA graph
     vs eager, launches per step, profiler rows);
  3s. speculative decoding at phase 3's width and settings: one verify
     step (C = 5, every position's logits) with the kernels and with their
     plain versions, identical logits and pools; phase 3's 8 requests
     served greedily with the ngram drafter at spec_k 4 (accept statistics
     printed), then twice sampled (temperature 0.7, top-k 8, seeds 0-7),
     which must give identical streams;
  3t. telemetry, parallel samples and the trie watermark sweep at phase
     3's width and settings (`telemetry=True`, `trie_watermark=0.25`):
     phase 3's 8 requests, 0 and 1 at n_samples 2 (submitted first, so
     their clones install the step their parent's prefill completes and
     decode in lockstep with it), greedy, 16 new tokens each; three
     drains with telemetry on and two with it off, in turns. Each clone
     must equal its parent, cow_forks and trie_sweep_freed must be > 0,
     the off drains must give the on drains' streams, the Chrome trace
     must validate, KERNEL_COUNTERS' per-call counts must equal the
     kernels' launch counts (cuda_packed = B1; kernel = B3 + the decode
     launch), and the recording hooks (timed on the instance, as the
     reference's serve_slo bench times them) must take under 3 % of the
     step() wall (median of the on drains). Prints TTFT / ITL p50 / p99,
     the event counts, the Prometheus line count, the host cost of the
     169 per-call KERNEL_COUNTERS updates of one decode step and tok/s
     with telemetry on and off;
  4. a short --cim bp serve, which must launch B2, and the decode step
     breakdown of that server (B2's share of the step);
  4b. the seeded stochastic converter (SimLevel.NOISY, noise_seed 0) at
     full width: phase 3's serve with nibble-packed prequant weights (B6,
     B3 and the B3+B4 decode launch must launch), the kernel-vs-plain step
     check and the decode
     step breakdown again, then a short --cim bp-noisy serve with weights
     quantized on the fly, which must launch B5;
  5. B2/B5 at macro depths 9, 145 and 1024 (M in {4, 64}) bit-exact
     against their plain versions, B1/B6 equal to them at the even depth;
  6. a `kernels` JSON line (launches: B1, B3 and the decode launch from
     phase 3t's first drain, B2 from phase 4, B5 and B6 from phase 4b),
     then the result line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12          # H100 SXM HBM3 (data sheet)
F32_FLOP_S = 67e12             # H100 SXM f32 outside the tensor cores
INT_OP_S = 1979e12             # H100 SXM int8 tensor-core ops (dense)
# H100 SXM int32 outside the tensor cores: 132 SMs x 64 INT32 lanes (half
# the 128 FP32 lanes that give the data sheet's 67 TFLOP/s) x 1.98 GHz
INT32_OP_S = 132 * 64 * 1.98e9
# integer operations the counter hash of B5/B6 needs (murmur3 finalizer
# mix32 = 3 shifts + 3 xors + 2 multiplies = 8): per conversion, the group
# absorption (xor + mix32) and 12 uniforms (add + mix32 each); per output
# element, the row and column absorptions (2 x (xor + mix32))
HASH_OPS_PER_CONVERSION = 9 + 12 * 9
HASH_OPS_PER_OUTPUT = 2 * 9
FULL_TOL = 0                   # outputs of B5/B6 at FULL that may differ

# (name, rows of the decode-step MVM shapes: K, N, launches per step)
DECODE_MVMS = [("wq+wo", 2048, 2048, 48), ("wk+wv", 2048, 1024, 48),
               ("w_gate+w_up", 2048, 8192, 48), ("w_down", 8192, 2048, 24),
               ("head", 2048, 92544, 1)]
PARITY_KN = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048),
             (2048, 92544)]
DEPTHS = (9, 145, 1024)        # macro depths of phase 5 (the default is 144)
# B3's head dims and block sizes past its fast case (dh in {32, 64, 128,
# 256}, bs <= 32): bf16 rows of dh 20 are 40 bytes; dh 56 is deepseek-v3's
# MLA head dim, dh 80 stablelm-3b's
C1_SHAPES = ((16, 16), (80, 16), (56, 16), (20, 16), (128, 48), (128, 64),
             (80, 128))
SPEC_K = 4
# the Telemetry hooks the Server calls (event() is the shared internal
# path of cow_fork and preempt, so it is not wrapped); now() is not a hook
TEL_HOOKS = ("submit", "admit", "prefill_chunk", "first_token", "emission",
             "decode_step", "spec_verify", "cow_fork", "preempt", "retire",
             "step_snapshot")
HOOK_LIMIT = 0.03              # hook time / step() wall, the reference's


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def time_ms(torch, fn, arg_sets, reps: int = 5, min_iters: int = 10) -> float:
    """Median over `reps` of the mean time of one call, CUDA events around
    a run that cycles through `arg_sets` (distinct buffers, so weights come
    from device memory and not from the 50 MB L2)."""
    n = max(len(arg_sets), min_iters)
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def graph_ms(torch, fn, arg_sets, reps: int = 5, min_iters: int = 10) -> float:
    """Device time of one call: the calls (cycling through `arg_sets`)
    captured once into a CUDA graph, CUDA events around its replays. The
    Python wrappers' host time drops out; what is left is the card's."""
    n = max(len(arg_sets), min_iters)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the default stream
        for a in arg_sets[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def copies(t, min_total: int = 128 << 20):
    """Enough clones of `t` to exceed the L2 cache when cycled."""
    n = max(1, math.ceil(min_total / (t.numel() * t.element_size())))
    return [t] + [t.clone() for _ in range(n - 1)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.adc import stochastic_transfer_params
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.core.macro import MacroConfig, SimLevel
    from repro_torch.kernels import build, cim_mvm as cm, ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.core import engine
    from repro_torch.core.engine import PackedCodes
    from repro_torch.models import common, registry, transformer
    from repro_torch.runtime import obs
    from repro_torch.runtime.server import (Request, Server, ServerMetrics,
                                            ServingConfig)
    from repro_torch.runtime.speculative import SamplingParams
    from repro_torch.runtime.telemetry import KERNEL_COUNTERS

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls stay f32
    dev = torch.device("cuda")

    # ---- phase 1: card, build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = smi.stdout.strip().splitlines()
    check(smi.returncode == 0 and bool(lines) and "," in lines[0],
          f"nvidia-smi gave no name and power limit (exit "
          f"{smi.returncode}): {smi.stderr.strip()[:200]}")
    card = lines[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    built = build.build_all()
    log(f"phase 1: kernels built in {time.monotonic() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in built.items()) or 'cached'})")

    report = {}
    kw = dict(n_rows=144, levels=362, gain=1.0, full_scale=32400.0)
    rng = np.random.default_rng(0)

    def codes(shape):
        return torch.from_numpy(rng.integers(0, 16, size=shape,
                                             dtype=np.uint8)).to(dev).float()

    # ---- phase 2: kernels against their plain versions --------------------
    err = {"B1": 0.0, "B2": 0.0}
    for m in (4, 64):
        for k, n in PARITY_KN:
            x, w = codes((m, k)), codes((k, n))
            wp = ops.pack_codes(w).contiguous()
            y1 = cm.cim_mvm_grouped_packed(x, wp, **kw)
            y1p = cm.cim_mvm_grouped_packed_plain(x, wp, **kw)
            y2 = cm.cim_mvm_grouped(x, w, **kw)
            y2p = cm.cim_mvm_grouped_plain(x, w, **kw)
            torch.cuda.synchronize()
            e1 = (y1 - y1p).abs().max().item()
            e2 = (y2 - y2p).abs().max().item()
            check(torch.equal(y1, y1p), f"B1 differs from its plain version "
                  f"at M={m} K={k} N={n}: max |err| {e1}")
            check(torch.equal(y2, y2p), f"B2 differs from its plain version "
                  f"at M={m} K={k} N={n}: max |err| {e2}")
            err["B1"], err["B2"] = max(err["B1"], e1), max(err["B2"], e2)
            del x, w, wp, y1, y1p, y2, y2p
    log("phase 2: B1, B2 bit-exact vs plain at M in {4, 64} x "
        f"{PARITY_KN} (tolerance 0)")

    # B5/B6: the seeded stochastic converter, NOISY (and FULL once)
    def stochastic_kw(level):
        st = stochastic_transfer_params(MacroConfig(sim_level=level))
        return dict(kw, sigma=st["sigma"], inl_amp=st["inl_amp"],
                    apply_inl=st["apply_inl"])

    noisy_kw, full_kw = (stochastic_kw(SimLevel.NOISY),
                         stochastic_kw(SimLevel.FULL))
    seeds = {v: torch.tensor([v], dtype=torch.int32, device=dev)
             for v in (0, 7)}
    err["B5"] = err["B6"] = 0.0
    for m in (4, 64):
        for k, n in PARITY_KN:
            x, w = codes((m, k)), codes((k, n))
            wp = ops.pack_codes(w).contiguous()
            for sd, seed in seeds.items():
                y5 = cm.cim_mvm_grouped_noisy(x, w, seed, **noisy_kw)
                y6 = cm.cim_mvm_grouped_noisy_packed(x, wp, seed, **noisy_kw)
                y5p = cm.cim_mvm_grouped_noisy_plain(x, w, seed, **noisy_kw)
                y6p = cm.cim_mvm_grouped_noisy_packed_plain(x, wp, seed,
                                                            **noisy_kw)
                torch.cuda.synchronize()
                e5 = (y5 - y5p).abs().max().item()
                e6 = (y6 - y6p).abs().max().item()
                where = f"at M={m} K={k} N={n} seed {sd}"
                check(bool(torch.isfinite(y5).all()), f"B5 not finite {where}")
                check(torch.equal(y5, y5p), f"B5 differs from its plain "
                      f"version {where}: max |err| {e5}")
                check(torch.equal(y6, y6p), f"B6 differs from its plain "
                      f"version {where}: max |err| {e6}")
                check(torch.equal(y6, y5), f"B6 differs from B5 {where}")
                err["B5"], err["B6"] = max(err["B5"], e5), max(err["B6"], e6)
                if sd == 0:
                    y0 = y5
            salted = cm.cim_mvm_grouped_noisy(x, w, seeds[0], inl_seed=3,
                                              **noisy_kw)
            check(not torch.equal(salted, y0), f"inl_seed 3 drew the same "
                  f"noise as inl_seed 0 at M={m} K={k} N={n}")
            del x, w, wp, y5, y6, y5p, y6p, y0, salted
    log("phase 2: B5, B6 bit-exact vs plain at NOISY, M in {4, 64} x "
        f"{PARITY_KN}, seeds 0 and 7 (tolerance 0); B6 == B5; inl_seed "
        "3 salts the draws")
    full_diff = 0
    for m in (4, 64):
        x, w = codes((m, 2048)), codes((2048, 2048))
        wp = ops.pack_codes(w).contiguous()
        y5 = cm.cim_mvm_grouped_noisy(x, w, seeds[7], inl_seed=3, **full_kw)
        y6 = cm.cim_mvm_grouped_noisy_packed(x, wp, seeds[7], inl_seed=3,
                                             **full_kw)
        y5p = cm.cim_mvm_grouped_noisy_plain(x, w, seeds[7], inl_seed=3,
                                             **full_kw)
        torch.cuda.synchronize()
        full_diff += int((y5 != y5p).sum()) + int((y6 != y5p).sum())
        err["B5"] = max(err["B5"], (y5 - y5p).abs().max().item())
        err["B6"] = max(err["B6"], (y6 - y5p).abs().max().item())
        del x, w, wp, y5, y6, y5p
    log(f"phase 2: B5, B6 at FULL (INL instance 3), M in {{4, 64}}, "
        f"K=N=2048: {full_diff} outputs differ from the plain version "
        f"(tolerance {FULL_TOL})")
    check(full_diff <= FULL_TOL, "B5/B6 at FULL differ from their plain "
          "versions beyond the tolerance")

    # decode-step timing: M = 4 slots, every MVM shape of one step
    mvms = {"B1": (cm.cim_mvm_grouped_packed, cm.cim_mvm_grouped_packed_plain,
                   True, {}),
            "B2": (cm.cim_mvm_grouped, cm.cim_mvm_grouped_plain, False, {}),
            "B5": (cm.cim_mvm_grouped_noisy, cm.cim_mvm_grouped_noisy_plain,
                   False, noisy_kw),
            "B6": (cm.cim_mvm_grouped_noisy_packed,
                   cm.cim_mvm_grouped_noisy_packed_plain, True, noisy_kw)}
    for name, (kern, plain, packed, nkw) in mvms.items():
        tot = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bytes": 0.0,
               "ops": 0.0, "hash_ops": 0.0}
        extra = (seeds[0],) if nkw else ()
        fkw = nkw or kw

        def run_k(a, b):
            return kern(a, b, *extra, **fkw)

        def run_p(a, b):
            return plain(a, b, *extra, **fkw)

        for label, k, n, count in DECODE_MVMS:
            x = codes((4, k))
            w = codes((k, n))
            w = ops.pack_codes(w).contiguous() if packed else w
            ws = copies(w)
            args = [(x, wi) for wi in ws]
            t_k = graph_ms(torch, run_k, args)
            t_call = time_ms(torch, run_k, args)
            t_p = graph_ms(torch, run_p, args[:4], reps=3, min_iters=4)
            wbytes = w.numel() * w.element_size()
            log(f"  {name} {label:12s} M=4 K={k} N={n} x{count}/step: "
                f"kernel {t_k * 1e3:.2f} us on the card "
                f"({wbytes / (t_k * 1e-3) / 1e12:.3f} TB/s of "
                f"{wbytes / 1e6:.2f} MB weights), {t_call * 1e3:.2f} us "
                f"per eager call, plain {t_p * 1e3:.2f} us")
            tot["ms"] += count * t_k
            tot["call_ms"] += count * t_call
            tot["plain_ms"] += count * t_p
            tot["bytes"] += count * (wbytes + 4 * k * 4 + 4 * n * 4)
            tot["ops"] += count * 2 * 4 * k * n
            if nkw:
                groups = -(-k // kw["n_rows"])
                tot["hash_ops"] += count * (
                    4 * n * groups * HASH_OPS_PER_CONVERSION
                    + 4 * n * HASH_OPS_PER_OUTPUT)
            del x, w, ws
        b_bytes = tot["bytes"] / HBM_BYTES_S * 1e3
        b_ops = max(tot["ops"] / INT_OP_S, tot["hash_ops"] / INT32_OP_S) * 1e3
        report[name] = dict(
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=max(b_bytes, b_ops),
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            library_ms=None, max_abs_err=err[name])
        log(f"  {name} one decode step (169 MVMs): kernel {tot['ms']:.3f} ms "
            f"on the card, {tot['call_ms']:.3f} ms as eager calls, plain "
            f"{tot['plain_ms']:.3f} ms, bound {max(b_bytes, b_ops):.3f} ms "
            f"(weight bytes / 3.35 TB/s: {b_bytes:.3f} ms; operations: "
            f"{b_ops:.3f} ms, hash {tot['hash_ops'] / 1e9:.3f} G int32 ops)")
        # a prefill chunk: 4 slots x 16 tokens = 64 rows through the 168
        # layer MVMs (the head sees only each lane's last row, M = 4, timed
        # above)
        pre = {"ms": 0.0, "bytes": 0.0, "ops": 0.0, "hash_ops": 0.0}
        for label, k, n, count in DECODE_MVMS[:-1]:
            x = codes((64, k))
            w = codes((k, n))
            w = ops.pack_codes(w).contiguous() if packed else w
            ws = copies(w)
            t_k = graph_ms(torch, run_k, [(x, wi) for wi in ws])
            wbytes = w.numel() * w.element_size()
            log(f"  {name} {label:12s} M=64 K={k} N={n} x{count}/chunk: "
                f"kernel {t_k * 1e3:.2f} us on the card "
                f"({wbytes / (t_k * 1e-3) / 1e12:.3f} TB/s of weights)")
            pre["ms"] += count * t_k
            pre["bytes"] += count * (wbytes + 64 * k * 4 + 64 * n * 4)
            pre["ops"] += count * 2 * 64 * k * n
            if nkw:
                pre["hash_ops"] += count * 64 * n * (
                    -(-k // kw["n_rows"]) * HASH_OPS_PER_CONVERSION
                    + HASH_OPS_PER_OUTPUT)
            del x, w, ws
        pb_bytes = pre["bytes"] / HBM_BYTES_S * 1e3
        pb_ops = max(pre["ops"] / INT_OP_S,
                     pre["hash_ops"] / INT32_OP_S) * 1e3
        log(f"  {name} one prefill chunk's 168 layer MVMs at M=64: kernel "
            f"{pre['ms']:.3f} ms on the card, bound "
            f"{max(pb_bytes, pb_ops):.3f} ms (bytes {pb_bytes:.3f} ms, "
            f"operations {pb_ops:.3f} ms, hash "
            f"{pre['hash_ops'] / 1e9:.3f} G int32 ops)")
        if name != "B1":
            continue
        # a speculative verify step: 4 slots x (spec_k + 1) positions, the
        # head included (every position's logits)
        m_v = 4 * (SPEC_K + 1)
        ver = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0}
        for label, k, n, count in DECODE_MVMS:
            x = codes((m_v, k))
            ws = copies(ops.pack_codes(codes((k, n))).contiguous())
            args = [(x, wi) for wi in ws]
            t_k = graph_ms(torch, run_k, args)
            t_p = graph_ms(torch, run_p, args[:4], reps=3, min_iters=4)
            wbytes = ws[0].numel()
            log(f"  B1 {label:12s} M={m_v} K={k} N={n} x{count}/verify "
                f"step: kernel {t_k * 1e3:.2f} us on the card, plain "
                f"{t_p * 1e3:.2f} us")
            ver["ms"] += count * t_k
            ver["plain_ms"] += count * t_p
            ver["bytes"] += count * (wbytes + m_v * k * 4 + m_v * n * 4)
            ver["ops"] += count * 2 * m_v * k * n
            del x, ws
        vb = max(ver["bytes"] / HBM_BYTES_S, ver["ops"] / INT_OP_S) * 1e3
        log(f"  B1 one verify step (169 MVMs at M={m_v}): kernel "
            f"{ver['ms']:.3f} ms on the card, plain {ver['plain_ms']:.3f} "
            f"ms, bound {vb:.3f} ms")

    # B3: paged flash attention at the main path's shapes
    b, kh, g, dh, bs, mb = 4, 8, 2, 128, 16, 16
    nb = b * mb + 1
    k_pool = torch.from_numpy(rng.standard_normal((nb, bs, kh, dh),
                                                  dtype=np.float32)).to(dev)
    v_pool = torch.from_numpy(rng.standard_normal((nb, bs, kh, dh),
                                                  dtype=np.float32)).to(dev)
    k_pool, v_pool = k_pool.bfloat16(), v_pool.bfloat16()
    k_pool[0] = float("nan")        # trash block poison
    v_pool[0] = float("nan")
    lens = torch.tensor([0, 37, 130, 224], dtype=torch.int32, device=dev)
    tables = torch.zeros(b, mb, dtype=torch.int32, device=dev)
    perm = rng.permutation(np.arange(1, nb))
    for s in range(b):
        tables[s] = torch.from_numpy(perm[s * mb:(s + 1) * mb].astype(
            np.int32))
    b3_err = 0.0
    for c in (1, 16):
        valid = torch.tensor([0, c, c, c], dtype=torch.int32, device=dev)
        kvl = lens + valid
        q = torch.from_numpy(rng.standard_normal((b, c, kh * g, dh),
                                                 dtype=np.float32)).to(dev)
        o = pa.paged_attn_call(q, k_pool, v_pool, tables, lens, kvl)
        op = pa.paged_attn_plain(q, k_pool, v_pool, tables, lens, kvl)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(o).all()), f"B3 output not finite (C={c})")
        e = (o - op).abs().max().item()
        b3_err = max(b3_err, e)
        check(torch.equal(o, op), f"B3 differs from its plain version at "
              f"C={c}: max |err| {e} (tolerance 0)")
        check(bool((o[0] == 0).all()), "B3 idle lane must emit 0")
        if c == 1:
            q_dec, kvl_dec = q, kvl
        else:
            q_pre, kvl_pre = q, kvl
    log(f"phase 2: B3 bit-exact vs plain at C=1 and C=16, finite "
        f"(tolerance 0)")
    pool_copies = list(zip(copies(k_pool), copies(v_pool)))
    t_k = graph_ms(torch, lambda kp, vp: pa.paged_attn_call(
        q_dec, kp, vp, tables, lens, kvl_dec), pool_copies)
    t_call = time_ms(torch, lambda kp, vp: pa.paged_attn_call(
        q_dec, kp, vp, tables, lens, kvl_dec), pool_copies)
    t_p = graph_ms(torch, lambda kp, vp: pa.paged_attn_plain(
        q_dec, kp, vp, tables, lens, kvl_dec), pool_copies[:4], reps=3,
        min_iters=4)
    # library yardstick: SDPA over the pre-gathered bf16 window (the gather
    # is not timed), same masks
    win = mb * bs
    kw_ = common.paged_gather(k_pool, tables).permute(0, 2, 1, 3)
    vw_ = common.paged_gather(v_pool, tables).permute(0, 2, 1, 3)
    vw_ = torch.where((torch.arange(win, device=dev)[None, :]
                       < kvl_dec[:, None].long())[:, None, :, None], vw_, 0)
    qs = q_dec.permute(0, 2, 1, 3).bfloat16()
    mask = (torch.arange(win, device=dev)[None, :]
            < kvl_dec[:, None].long())[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_lib = graph_ms(torch, lambda: sdpa(qs, kw_, vw_, attn_mask=mask,
                                         enable_gqa=True), [()])
    kv_tokens = int(kvl_dec.sum())
    b3_bytes = kv_tokens * kh * dh * 2 * 2 + 2 * q_dec.numel() * 4
    b3_ops = kv_tokens * kh * g * dh * 4
    b_bytes, b_ops = b3_bytes / HBM_BYTES_S * 1e3, b3_ops / F32_FLOP_S * 1e3
    report["B3"] = dict(ms=t_k, plain_ms=t_p, bound_ms=max(b_bytes, b_ops),
                        bound_by="bytes" if b_bytes >= b_ops
                        else "operations", library_ms=t_lib,
                        max_abs_err=b3_err)
    log(f"  B3 decode C=1 B={b} KH={kh} G={g} dh={dh} bs={bs} "
        f"kv_len={kvl_dec.tolist()}: kernel {t_k * 1e3:.2f} us on the "
        f"card, {t_call * 1e3:.2f} us per eager call, plain "
        f"{t_p * 1e3:.2f} us, SDPA on the gathered window "
        f"{t_lib * 1e3:.2f} us")

    def b3_row(tag, q, kp, vp, tb, ln, kvl, pc=None):
        """Time B3 (CUDA-graph replays over pool copies `pc`) beside its
        plain version, SDPA on the pre-gathered window with the same causal
        and length masks (the gather is not timed) and its bound; log one
        row."""
        pc = pc or list(zip(copies(kp), copies(vp)))
        t_k = graph_ms(torch, lambda a, v: pa.paged_attn_call(
            q, a, v, tb, ln, kvl), pc)
        t_p = graph_ms(torch, lambda a, v: pa.paged_attn_plain(
            q, a, v, tb, ln, kvl), pc[:2], reps=3, min_iters=2)
        kh_, dh_ = kp.shape[2], kp.shape[3]
        pos_q = ln[:, None].long() + torch.arange(q.shape[1],
                                                  device=dev)[None, :]
        pos_s = torch.arange(tb.shape[1] * kp.shape[1], device=dev)
        kw = common.paged_gather(kp, tb).permute(0, 2, 1, 3)
        vw = torch.where((pos_s[None, :] < kvl[:, None].long())[
            :, None, :, None], common.paged_gather(vp, tb).permute(
                0, 2, 1, 3), 0)
        mask = ((pos_s[None, None, :] <= pos_q[:, :, None])
                & (pos_s[None, None, :] < kvl[:, None, None].long()))[:, None]
        qs = q.permute(0, 2, 1, 3).to(kp.dtype)
        t_lib = graph_ms(torch, lambda: sdpa(qs, kw, vw, attn_mask=mask,
                                             enable_gqa=True), [()])
        # bound: each slot's K/V rows read once, q read and out written
        # once; each query row attends its causal prefix
        att = torch.minimum(pos_q + 1, kvl[:, None].long()).sum().item()
        bb = (int(kvl.sum()) * kh_ * dh_ * kp.element_size() * 2
              + 2 * q.numel() * 4) / HBM_BYTES_S * 1e3
        bo = att * (q.shape[2] // kh_) * kh_ * dh_ * 4 / F32_FLOP_S * 1e3
        log(f"  B3 {tag} kv_len={kvl.tolist()}: kernel {t_k * 1e3:.2f} us "
            f"on the card, plain {t_p * 1e3:.2f} us, SDPA on the gathered "
            f"window {t_lib * 1e3:.2f} us, bound {max(bb, bo) * 1e3:.2f} us "
            f"({'bytes' if bb >= bo else 'operations'})")

    # B3 at a prefill chunk (C = 16: 32 query rows per KV head)
    b3_row("prefill C=16", q_pre, k_pool, v_pool, tables, lens, kvl_pre,
           pool_copies)

    # B4: the decode K/V write, inside B3's decode launch. Slot s writes
    # its new row at its position lens[s] (slot 0 idle: flat 0), as
    # paged_step builds the targets
    nk = torch.from_numpy(rng.standard_normal((b, 1, kh, dh),
                                              dtype=np.float32)).to(dev)
    nv = torch.from_numpy(rng.standard_normal((b, 1, kh, dh),
                                              dtype=np.float32)).to(dev)
    nk, nv = nk.bfloat16(), nv.bfloat16()
    col = (lens // bs).long()
    flat = (tables.gather(1, col[:, None])[:, 0] * bs + lens % bs).int()
    flat[0] = 0
    b4_err = 0.0
    for qx, out_dtype in ((q_dec, torch.float32),
                          (q_dec.bfloat16(), torch.bfloat16)):
        k2, v2, k3, v3 = (t.clone() for t in (k_pool, v_pool, k_pool,
                                              v_pool))
        o = pa.decode_write_attend_call(qx, k2, v2, nk, nv, flat, tables,
                                        lens, kvl_dec, out_dtype=out_dtype)
        op = pa.decode_write_attend_plain(qx, k3, v3, nk, nv, flat, tables,
                                          lens, kvl_dec).to(out_dtype)
        torch.cuda.synchronize()
        same = torch.equal(k2.view(torch.int16), k3.view(torch.int16)) and \
            torch.equal(v2.view(torch.int16), v3.view(torch.int16))
        check(same, "the decode launch's pools differ from B4's plain "
              "version")
        check(not torch.equal(k2.view(torch.int16), k_pool.view(torch.int16)),
              "the decode launch wrote no row")
        e = (o.float() - op.float()).abs().max().item()
        b4_err = max(b4_err, e)
        check(bool(torch.isfinite(o).all()) and torch.equal(o, op),
              f"the decode launch ({out_dtype}) differs from B4 then B3 "
              f"plain: max |err| {e} (tolerance 0)")
    log("phase 2: B3+B4 decode launch bit-exact vs B4 then B3 plain "
        "(outputs at f32 and bf16, both pools; tolerance 0)")
    del k3, v3

    # B4's time: the decode launch less B3 alone, same shapes, as the model
    # calls them (bf16 q and output), in turns (fused, B3, B3, fused)
    q16 = q_dec.bfloat16()

    def fused(kp, vp):
        return pa.decode_write_attend_call(q16, kp, vp, nk, nv, flat, tables,
                                           lens, kvl_dec,
                                           out_dtype=torch.bfloat16)

    def b3_alone(kp, vp):
        return pa.paged_attn_call(q16, kp, vp, tables, lens, kvl_dec,
                                  out_dtype=torch.bfloat16)

    t_f = [graph_ms(torch, fused, pool_copies)]
    t_b = [graph_ms(torch, b3_alone, pool_copies),
           graph_ms(torch, b3_alone, pool_copies)]
    t_f.append(graph_ms(torch, fused, pool_copies))
    t_fused, t_b3 = statistics.mean(t_f), statistics.mean(t_b)
    t_call = time_ms(torch, fused, pool_copies)
    k3, v3 = k_pool.clone(), v_pool.clone()
    t_p = graph_ms(torch, lambda: pa.fused_write_plain(k3, v3, nk, nv, flat),
                   [()], min_iters=20)
    rows = flat.long()
    kflat = k3.view(nb * bs, kh, dh)
    nk2 = nk.reshape(b, kh, dh)
    t_lib = graph_ms(torch, lambda: kflat.index_copy_(0, rows, nk2), [()],
                     min_iters=100)
    b4_bytes = 4 * b * kh * dh * 2       # K and V rows, read once, written once
    report["B4"] = dict(ms=t_fused - t_b3, plain_ms=t_p,
                        bound_ms=b4_bytes / HBM_BYTES_S * 1e3,
                        bound_by="bytes", library_ms=2 * t_lib,
                        max_abs_err=b4_err)
    log(f"  B4 B={b} rows of KH={kh} x dh={dh} bf16 inside the decode "
        f"launch: decode launch {' / '.join(f'{t * 1e3:.3f}' for t in t_f)} "
        f"us, B3 alone {' / '.join(f'{t * 1e3:.3f}' for t in t_b)} us "
        f"(bf16 q and output) -> B4 {(t_fused - t_b3) * 1e3:.3f} us; "
        f"{t_call * 1e3:.2f} us per eager call of the decode launch; plain "
        f"B4 {t_p * 1e3:.2f} us, 2x index_copy_ {2 * t_lib * 1e3:.2f} us")
    # B3 at a speculative verify step: C = spec_k + 1 query positions per
    # slot at decode depth (the new K/V already written)
    c_v = SPEC_K + 1
    kvl_v = lens + torch.tensor([0, c_v, c_v, c_v], dtype=torch.int32,
                                  device=dev)
    q_v = torch.from_numpy(rng.standard_normal((b, c_v, kh * g, dh),
                                               dtype=np.float32)).to(dev)
    o = pa.paged_attn_call(q_v, k_pool, v_pool, tables, lens, kvl_v)
    check(torch.equal(o, pa.paged_attn_plain(q_v, k_pool, v_pool, tables,
                                             lens, kvl_v)),
          "B3 differs from its plain version at the verify step C=5")
    b3_row(f"verify step C={c_v}", q_v, k_pool, v_pool, tables, lens, kvl_v,
           pool_copies)
    del k_pool, v_pool, k2, v2, k3, v3, pool_copies, kw_, vw_

    # B3 and the B3+B4 decode launch at every head dim and block size the
    # reference takes (C1 shapes), both pool dtypes, against the plain pair
    def c1_case(dh_, bs_, dtype):
        mb_ = max(2, 256 // bs_)
        nb_ = b * mb_ + 1
        kp_ = torch.from_numpy(rng.standard_normal(
            (nb_, bs_, kh, dh_), dtype=np.float32)).to(dev, dtype)
        vp_ = torch.from_numpy(rng.standard_normal(
            (nb_, bs_, kh, dh_), dtype=np.float32)).to(dev, dtype)
        kp_[0] = float("nan")
        vp_[0] = float("nan")
        tb_ = torch.from_numpy(rng.permutation(np.arange(1, nb_)).astype(
            np.int32)[:b * mb_].reshape(b, mb_)).to(dev)
        w_ = mb_ * bs_
        ln_ = torch.tensor([0, 37, w_ // 2 + 5, w_ - 17], dtype=torch.int32,
                           device=dev)
        return kp_, vp_, tb_, ln_

    for dh_, bs_ in C1_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            kp_, vp_, tb_, ln_ = c1_case(dh_, bs_, dtype)
            where = f"at dh={dh_} bs={bs_} {dtype}"
            for c in (1, SPEC_K + 1, 16):
                kvl_ = ln_ + torch.tensor([0, c, c, c], dtype=torch.int32,
                                          device=dev)
                q_ = torch.from_numpy(rng.standard_normal(
                    (b, c, kh * g, dh_), dtype=np.float32)).to(dev)
                o = pa.paged_attn_call(q_, kp_, vp_, tb_, ln_, kvl_)
                op = pa.paged_attn_plain(q_, kp_, vp_, tb_, ln_, kvl_)
                torch.cuda.synchronize()
                e = (o - op).abs().max().item()
                b3_err = max(b3_err, e)
                check(bool(torch.isfinite(o).all()) and torch.equal(o, op),
                      f"B3 differs from its plain version {where} C={c}: "
                      f"max |err| {e}")
            kvl_ = ln_ + torch.tensor([0, 1, 1, 1], dtype=torch.int32,
                                      device=dev)
            nk_ = torch.from_numpy(rng.standard_normal(
                (b, 1, kh, dh_), dtype=np.float32)).to(dev, dtype)
            nv_ = torch.from_numpy(rng.standard_normal(
                (b, 1, kh, dh_), dtype=np.float32)).to(dev, dtype)
            fl_ = (tb_.gather(1, (ln_ // bs_).long()[:, None])[:, 0] * bs_
                   + ln_ % bs_).int()
            fl_[0] = 0
            q_ = torch.from_numpy(rng.standard_normal(
                (b, 1, kh * g, dh_), dtype=np.float32)).to(dev)
            k2, v2, k3, v3 = (t.clone() for t in (kp_, vp_, kp_, vp_))
            o = pa.decode_write_attend_call(q_, k2, v2, nk_, nv_, fl_, tb_,
                                            ln_, kvl_)
            op = pa.decode_write_attend_plain(q_, k3, v3, nk_, nv_, fl_,
                                              tb_, ln_, kvl_)
            torch.cuda.synchronize()
            ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
            check(torch.equal(k2.view(ints), k3.view(ints))
                  and torch.equal(v2.view(ints), v3.view(ints))
                  and not torch.equal(k2.view(ints), kp_.view(ints)),
                  f"the decode launch's pools differ from B4's plain "
                  f"version {where}")
            e = (o - op).abs().max().item()
            b4_err = max(b4_err, e)
            check(torch.equal(o, op), f"the decode launch differs from B4 "
                  f"then B3 plain {where}: max |err| {e}")
            del kp_, vp_, k2, v2, k3, v3
    report["B3"]["max_abs_err"] = b3_err
    report["B4"]["max_abs_err"] = b4_err
    log(f"phase 2: B3 (C in 1, {SPEC_K + 1}, 16) and the B3+B4 decode "
        f"launch bit-exact vs plain at (dh, bs) in {list(C1_SHAPES)}, bf16 "
        "and f32 pools (tolerance 0)")
    # B3 alone at decode (f32 q, bf16 pools, as the dh 128 / bs 16 row
    # above) at dh 80 / bs 16 and dh 128 / bs 64
    for dh_, bs_ in ((80, 16), (128, 64)):
        kp_, vp_, tb_, ln_ = c1_case(dh_, bs_, torch.bfloat16)
        kvl_ = ln_ + torch.tensor([0, 1, 1, 1], dtype=torch.int32, device=dev)
        q_ = torch.from_numpy(rng.standard_normal(
            (b, 1, kh * g, dh_), dtype=np.float32)).to(dev)
        b3_row(f"decode C=1 dh={dh_} bs={bs_} MB={tb_.shape[1]}", q_, kp_,
               vp_, tb_, ln_, kvl_)
        del kp_, vp_

    # ---- shared by phases 3, 4 and 4b ------------------------------------
    def serve_mix(server, prompts, tag, sampling=None):
        """Phase 3's 8-request mix, 16 new tokens each (request i sampled
        with `sampling` and seed i, greedy without); launch counts are
        reset just before and read just after. Returns (the counts, the
        token streams)."""
        reqs = [Request(prompt=p, max_new_tokens=16) if sampling is None
                else Request(prompt=p, max_new_tokens=16,
                             sampling=SamplingParams(**sampling, seed=i))
                for i, p in enumerate(prompts)]
        # host wall time of each scheduler step (each ends by reading the
        # sampled tokens back), split by whether it prefilled
        step_s = {"prefill": [], "decode": []}
        inner = server.step

        def timed_step():
            t, before = time.monotonic(), server.metrics.prefill_tokens
            inner()
            kind = ("prefill" if server.metrics.prefill_tokens > before
                    else "decode")
            step_s[kind].append(time.monotonic() - t)

        server.step = timed_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.monotonic()
        for r in reqs:
            server.submit(r)
        server.run_until_drained()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        counts = build.launch_counts()
        del server.step
        log(f"{tag}: host time per step: " + ", ".join(
            f"{len(v)} {k} steps, median {1e3 * statistics.median(v):.1f} "
            f"ms, total {sum(v):.2f} s" for k, v in step_s.items() if v))
        peak = torch.cuda.max_memory_allocated() / 2**30
        for r in reqs:
            log(f"{tag} req{r.rid}: prompt_len={len(r.prompt)} -> {r.output}")
            check(len(r.output) == 16 and all(0 <= t < cfg.vocab
                                              for t in r.output),
                  f"{tag} req{r.rid}: bad output {r.output}")
        total = sum(len(r.output) for r in reqs)
        m = server.metrics.summary()
        log(f"{tag}: 8 requests, {total} tokens, {server.steps_run} steps, "
            f"{dt:.2f} s ({total / dt:.1f} tok/s), peak memory {peak:.2f} "
            f"GiB, prefix_hit_tokens={m['prefix_hit_tokens']} "
            f"cow_forks={m['cow_forks']} preemptions={m['preemptions']}")
        log(f"{tag}: launches {counts}")
        if server.drafter is not None:
            log(f"{tag}: speculative drafter={server.serving.drafter} "
                f"spec_k={server.spec_k} spec_steps={m['spec_steps']} "
                f"draft_tokens={m['draft_tokens']} accept_rate="
                f"{m['accept_rate']:.4f} mean_accept_len="
                f"{m['mean_accept_len']:.4f} accept_hist={m['accept_hist']}")
        check(m["prefix_hit_tokens"] >= 32, "the shared prefix was not reused")
        return counts, [r.output for r in reqs]

    def two_steps(server, step_cfg):
        """One prefill (C=16) and one decode step from an empty pool."""
        cache = transformer.init_paged_cache(step_cfg, 4 * 16 + 1, 16,
                                             device=dev)
        tb = torch.arange(1, 65, dtype=torch.int32, device=dev).reshape(4, 16)
        srng = np.random.RandomState(7)
        toks = torch.from_numpy(srng.randint(0, cfg.vocab, (4, 16))).to(dev)
        valid = torch.tensor([16, 16, 9, 0], device=dev)
        l1, cache = transformer.paged_step(
            server.params, toks, cache, tb, torch.zeros(4, device=dev,
                                                        dtype=torch.long),
            valid, step_cfg)
        nxt = torch.from_numpy(srng.randint(0, cfg.vocab, (4, 1))).to(dev)
        l2, cache = transformer.paged_step(
            server.params, nxt, cache, tb, valid,
            torch.tensor([1, 1, 1, 0], device=dev), step_cfg)
        return l1, l2

    def check_steps(server, tag):
        """The two steps with the kernels and with their plain versions
        must give identical logits."""
        l_k = two_steps(server, server.cfg)
        plain_cfg = server.cfg.replace(
            attn_backend="plain",
            cim=dataclasses.replace(server.cfg.cim, backend="plain"))
        l_p = two_steps(server, plain_cfg)
        torch.cuda.synchronize()
        step_err = 0.0
        for a, p_ in zip(l_k, l_p):
            check(a.shape == (4, cfg.vocab) and bool(torch.isfinite(a).all()),
                  "paged_step logits malformed")
            step_err = max(step_err, (a[:3] - p_[:3]).abs().max().item())
        log(f"{tag}: paged_step prefill C=16 + decode C=1, kernels vs plain "
            f"versions: max |dlogit| = {step_err} (tolerance 0, bit-exact)")
        check(step_err == 0.0, f"{tag}: kernel and plain paged_step logits "
              "differ")

    def decode_breakdown(server, tag):
        """Where a decode step's time goes: the whole C=1 step captured
        into a CUDA graph gives the card's time; the eager step adds the
        host's; torch.profiler gives device time by kernel name."""
        dcache = transformer.init_paged_cache(server.cfg, 4 * 16 + 1, 16,
                                              device=dev)
        dtb = torch.arange(1, 65, dtype=torch.int32,
                           device=dev).reshape(4, 16)
        dlens = torch.tensor([40, 100, 17, 0], device=dev)
        dvalid = torch.tensor([1, 1, 1, 0], device=dev)
        dtok = torch.from_numpy(np.random.RandomState(8).randint(
            0, cfg.vocab, (4, 1))).to(dev)

        def decode_step():
            transformer.paged_step(server.params, dtok, dcache, dtb, dlens,
                                   dvalid, server.cfg)

        t_dev = graph_ms(torch, decode_step, [()], reps=3, min_iters=3)
        t_eager = time_ms(torch, decode_step, [()], reps=3, min_iters=3)
        log(f"{tag}: one decode step (4 slots, C=1): {t_dev:.2f} ms on the "
            f"card (CUDA graph), {t_eager:.2f} ms eager -> the card is idle "
            f"{100 * (1 - t_dev / t_eager):.1f} % of the eager step")
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            decode_step()
            torch.cuda.synchronize()

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))

        # kernels only: an aten op's row repeats the time of its kernels
        rows_ = sorted((e for e in prof.key_averages()
                        if str(getattr(e, "device_type", "")).endswith(
                            "CUDA")), key=dev_us, reverse=True)
        total_us = sum(dev_us(e) for e in rows_)
        if total_us <= 0:
            log(f"{tag}: profiler recorded no device time (not measured)")
        else:
            log(f"{tag}: profiled decode step: {total_us / 1e3:.3f} ms of "
                f"kernel time in {sum(e.count for e in rows_)} launches "
                "(7,987 with B4 launched alone and the casts around B3)")
        for e in rows_[:12] if total_us > 0 else []:
            log(f"  profile: {dev_us(e) / 1e3:8.3f} ms "
                f"{100 * dev_us(e) / total_us:5.1f} %  x{e.count:<5d} "
                f"{e.key[:100]}")

    def short_serve(server, prompts, tag):
        """2 requests x 4 tokens; returns the launch counts of the run."""
        reqs = [Request(prompt=prompts[i][:24], max_new_tokens=4)
                for i in (1, 2)]
        build.reset_launch_counts()
        t0 = time.monotonic()
        for r in reqs:
            server.submit(r)
        server.run_until_drained()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        counts = build.launch_counts()
        for r in reqs:
            log(f"{tag} req{r.rid}: -> {r.output}")
            check(len(r.output) == 4, f"{tag} req{r.rid}: bad output "
                  f"{r.output}")
        log(f"{tag}: 2 requests x 4 tokens in {dt:.2f} s; launches {counts}")
        return counts

    # ---- phase 3: full-width paged serve, --cim bp-prequant --------------
    cfg = ARCHS["internlm2-1.8b"].replace(cim=CIMConfig(enabled=True))
    t0 = time.monotonic()
    params = registry.init_params(cfg, seed=0, device=dev)
    serving = ServingConfig(paged=True, prequant=True, packed=True,
                            attn="kernel", n_slots=4, max_len=256,
                            prefill_chunk=16)
    server = Server(params, cfg, serving, device=dev)
    torch.cuda.synchronize()
    log(f"phase 3: {cfg.arch} full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}) initialised and packed in "
        f"{time.monotonic() - t0:.1f} s")
    prng = np.random.RandomState(1234)
    prefix = prng.randint(0, cfg.vocab, size=32).tolist()
    lengths = prng.randint(16, 97, size=8)
    lengths[0], lengths[6] = max(lengths[0], 48), max(lengths[6], 40)
    prompts = [prng.randint(0, cfg.vocab, size=int(n)).tolist()
               for n in lengths]
    for i in (0, 6):
        prompts[i] = prefix + prompts[i][32:]
    counts, _ = serve_mix(server, prompts, "phase 3")
    # B3 runs alone at prefill and with B4 folded in at decode
    check(counts["paged_attn_call"] > 0, "B3 was not launched at prefill")
    for name, n in (("B1", counts["cim_mvm_grouped_packed"]),
                    ("B3+B4", counts["decode_write_attend_call"])):
        check(n > 0, f"{name} was not launched on the main path")
    check_steps(server, "phase 3")
    decode_breakdown(server, "phase 3")

    # ---- phase 3s: speculative decoding at phase 3's width ---------------
    # (a) one verify step (C = spec_k + 1, every position's logits) after a
    # prefill chunk, with the kernels and with their plain versions
    def verify_step(step_cfg):
        cache = transformer.init_paged_cache(step_cfg, 4 * 16 + 1, 16,
                                             device=dev)
        tb = torch.arange(1, 65, dtype=torch.int32, device=dev).reshape(4, 16)
        srng = np.random.RandomState(9)
        toks = torch.from_numpy(srng.randint(0, cfg.vocab, (4, 16))).to(dev)
        valid = torch.tensor([16, 16, 9, 0], device=dev)
        _, cache = transformer.paged_step(
            server.params, toks, cache, tb,
            torch.zeros(4, device=dev, dtype=torch.long), valid, step_cfg)
        draft = torch.from_numpy(srng.randint(0, cfg.vocab,
                                              (4, SPEC_K + 1))).to(dev)
        logits, cache = transformer.paged_step(
            server.params, draft, cache, tb, valid,
            torch.tensor([SPEC_K + 1, 3, 1, 0], device=dev), step_cfg,
            all_logits=True)
        return logits, cache["layers"]

    build.reset_launch_counts()
    l_k, pools_k = verify_step(server.cfg)
    torch.cuda.synchronize()
    v_counts = build.launch_counts()
    l_p, pools_p = verify_step(server.cfg.replace(
        attn_backend="plain",
        cim=dataclasses.replace(server.cfg.cim, backend="plain")))
    torch.cuda.synchronize()
    check(l_k.shape == (4, SPEC_K + 1, cfg.vocab)
          and bool(torch.isfinite(l_k[:3]).all()),
          "phase 3s: verify-step logits malformed")
    v_err = (l_k[:3] - l_p[:3]).abs().max().item()
    same_pools = all(torch.equal(pools_k[n][:, 1:].view(torch.int16),
                                 pools_p[n][:, 1:].view(torch.int16))
                     for n in ("k", "v"))
    log(f"phase 3s: verify step C={SPEC_K + 1} (all logits), kernels vs "
        f"plain versions: max |dlogit| = {v_err}, pools identical: "
        f"{same_pools} (tolerance 0); launches {v_counts}")
    check(v_err == 0.0 and same_pools, "phase 3s: kernel and plain verify "
          "steps differ")
    check(v_counts["cim_mvm_grouped_packed"] > 0
          and v_counts["paged_attn_call"] > 0,
          "phase 3s: the verify step did not launch B1 and B3")
    del server, l_k, l_p, pools_k, pools_p
    # (b) the greedy spec serve, (c) the sampled spec serve, twice
    spec_serving = dataclasses.replace(serving, drafter="ngram",
                                       spec_k=SPEC_K)
    counts, _ = serve_mix(Server(params, cfg, spec_serving, device=dev),
                          prompts, "phase 3s: greedy ngram")
    check(counts["cim_mvm_grouped_packed"] > 0
          and counts["paged_attn_call"] > 0,
          "phase 3s: the spec serve did not launch B1 and B3")
    sampled = dict(temperature=0.7, top_k=8)
    streams = [serve_mix(Server(params, cfg, spec_serving, device=dev),
                         prompts, f"phase 3s: sampled ngram run {i}",
                         sampling=sampled)[1] for i in (1, 2)]
    check(streams[0] == streams[1], "phase 3s: two sampled spec serves gave "
          "different streams")
    log("phase 3s: the two sampled spec serves (temperature 0.7, top-k 8, "
        "seeds 0-7) gave identical streams")

    # ---- phase 3t: telemetry, parallel samples, trie watermark -----------
    tel_serving = dataclasses.replace(serving, telemetry=True,
                                      trie_watermark=0.25)

    def drain_3t(server, hook_s):
        """One drain of phase 3t's mix on a reused server (prefix cache
        flushed, metrics and telemetry reset): the forked requests 0 and 1
        first, stepping until both clones are installed, then the rest.
        Returns (requests, launch counts, KERNEL_COUNTERS snapshot, drain
        seconds, step() wall seconds, hook seconds, seconds the host
        spent enqueueing the model steps)."""
        server.flush_prefix_cache()
        server.metrics = ServerMetrics()
        server.telemetry.reset()
        reqs = [Request(prompt=p, max_new_tokens=16,
                        n_samples=2 if i < 2 else 1)
                for i, p in enumerate(prompts)]
        wall, enqueue = [0.0], [0.0]
        inner, model_step = server.step, transformer.paged_step

        def timed_step():
            t = time.perf_counter()
            inner()
            wall[0] += time.perf_counter() - t

        def timed_model_step(*a, **kw):
            t = time.perf_counter()
            out = model_step(*a, **kw)
            enqueue[0] += time.perf_counter() - t
            return out

        server.step = timed_step
        transformer.paged_step = timed_model_step
        torch.cuda.synchronize()
        build.reset_launch_counts()
        KERNEL_COUNTERS.reset()
        hook_s[0] = 0.0
        t0 = time.monotonic()
        for r in reqs[:2]:
            server.submit(r)
        kids = [c for r in reqs[:2] for c in r.samples]
        for _ in range(64):
            if all(any(x is c for x in server.slot_req) for c in kids):
                break
            server.step()
        check(all(any(x is c for x in server.slot_req) for c in kids),
              "phase 3t: the clones were not installed")
        for r in reqs[2:]:
            server.submit(r)
        server.run_until_drained()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        del server.step
        transformer.paged_step = model_step
        return (reqs, build.launch_counts(), KERNEL_COUNTERS.snapshot(), dt,
                wall[0], hook_s[0], enqueue[0])

    def instrument(tel):
        """Shadow each recording hook on the instance with a self-timing
        wrapper; returns the accumulator."""
        acc = [0.0]
        for name in TEL_HOOKS:
            def timed(*a, _base=getattr(tel, name), **kw):
                t = time.perf_counter()
                r = _base(*a, **kw)
                acc[0] += time.perf_counter() - t
                return r
            setattr(tel, name, timed)
        return acc

    # one server drains with its telemetry switched on and off in turns
    # (on and off timed on the same instance); a second one, built with
    # ServingConfig(telemetry=False), drains once more
    srv_on = Server(params, cfg, tel_serving, device=dev)
    srv_off = Server(params, cfg, dataclasses.replace(tel_serving,
                                                      telemetry=False),
                     device=dev)
    check((srv_on._trie_hi, srv_on._trie_lo) == (16, 8),
          f"phase 3t: trie watermarks {srv_on._trie_hi}/{srv_on._trie_lo} "
          "blocks, expected 16/8 of 64")
    hooks_on, hooks_off = instrument(srv_on.telemetry), [0.0]
    ratios, streams_3t = [], []
    tok_s = {"on": [], "off": [], "config off": []}
    for i, leg in enumerate(("on", "off", "on", "off", "on", "config off")):
        srv = srv_off if leg == "config off" else srv_on
        srv.telemetry.enabled = leg == "on"
        reqs, counts, kc, dt, wall, hook, enq = drain_3t(
            srv, hooks_on if leg == "on" else hooks_off)
        m = srv.metrics.to_dict()
        done = [x for r in reqs for x in (r, *r.samples)]
        total = sum(len(x.output) for x in done)
        tok_s[leg].append(total / dt)
        streams_3t.append([x.output for x in done])
        tag = f"phase 3t ({card}): telemetry {leg} drain {i + 1}"
        for x in done:
            check(len(x.output) == 16 and all(0 <= t < cfg.vocab
                                              for t in x.output),
                  f"{tag} req{x.rid}: bad output {x.output}")
        for r in reqs[:2]:
            check(r.samples[0].output == r.output,
                  f"{tag}: clone req{r.samples[0].rid} {r.samples[0].output}"
                  f" differs from its parent req{r.rid} {r.output}")
        check(m["cow_forks"] > 0 and m["trie_sweep_freed"] > 0,
              f"{tag}: cow_forks {m['cow_forks']}, trie_sweep_freed "
              f"{m['trie_sweep_freed']}")
        b1 = counts["cim_mvm_grouped_packed"]
        b3 = counts["paged_attn_call"] + counts["decode_write_attend_call"]
        check(kc["backend_dispatch"] == {"cuda_packed": b1} and b1 > 0,
              f"{tag}: backend_dispatch {kc['backend_dispatch']} against "
              f"{b1} B1 launches")
        check(kc["attn_dispatch"] == {"kernel": b3}
              and counts["paged_attn_call"] > 0
              and counts["decode_write_attend_call"] > 0,
              f"{tag}: attn_dispatch {kc['attn_dispatch']} against B3 "
              f"{counts['paged_attn_call']} + decode launch "
              f"{counts['decode_write_attend_call']}")
        log(f"{tag}: {total} tokens in {m['steps']} steps, {dt:.2f} s "
            f"({total / dt:.1f} tok/s); step() wall {wall:.3f} s, of it "
            f"{enq:.3f} s enqueueing paged_step; "
            f"cow_forks={m['cow_forks']} trie_sweep_freed="
            f"{m['trie_sweep_freed']} prefix_hit_tokens="
            f"{m['prefix_hit_tokens']}; launches {counts}; "
            f"KERNEL_COUNTERS backend {kc['backend_dispatch']} attn "
            f"{kc['attn_dispatch']}")
        if leg != "on":
            check(not srv.telemetry.events, f"{tag}: recorded events")
            continue
        ratios.append(hook / wall)
        log(f"{tag}: recording hooks {hook * 1e3:.3f} ms = "
            f"{100 * hook / wall:.4f} % of step() wall")
        if len(ratios) == 1:
            main_launches = {"B1": b1, "B3": b3,
                             "B4": counts["decode_write_attend_call"]}
            log(f"phase 3t ({card}): launches of the first drain, the "
                f"kernels line's B1/B3/B4: {main_launches}")
    check(all(st == streams_3t[0] for st in streams_3t),
          "phase 3t: the drains gave different streams (telemetry on vs "
          "off, or drain to drain)")
    tel = srv_on.telemetry
    doc = obs.chrome_trace(tel)
    problems = obs.validate_chrome_trace(doc)
    check(problems == [], f"phase 3t: Chrome trace invalid: {problems[:5]}")
    prom = obs.prometheus_text(tel, srv_on)
    overhead = statistics.median(ratios)
    log(f"phase 3t ({card}): ttft p50 {tel.ttft.percentile(50) * 1e3:.3f} "
        f"ms p99 {tel.ttft.percentile(99) * 1e3:.3f} ms | itl p50 "
        f"{tel.itl.percentile(50) * 1e3:.3f} ms p99 "
        f"{tel.itl.percentile(99) * 1e3:.3f} ms | step_wall p50 "
        f"{tel.step_wall.percentile(50) * 1e3:.3f} ms (last on drain)")
    log(f"phase 3t ({card}): events by kind {dict(sorted(tel.counters.items()))}"
        f"; Chrome trace {len(doc['traceEvents'])} events, valid; "
        f"Prometheus {len(prom.splitlines())} lines")
    log(f"phase 3t ({card}): tok/s " + "; ".join(
        f"telemetry {k} {', '.join(f'{v:.2f}' for v in vs)}"
        for k, vs in tok_s.items()) + f"; hook overhead per on drain "
        f"{[f'{100 * r:.4f} %' for r in ratios]}, median "
        f"{100 * overhead:.4f} % (limit {100 * HOOK_LIMIT:.0f} %)")
    check(overhead < HOOK_LIMIT, f"phase 3t: telemetry hooks take "
          f"{100 * overhead:.3f} % of step() wall (limit 3 %)")
    # the host cost of KERNEL_COUNTERS per decode step: the engine hook
    # alone, on the 169 packed weights (`<name>_q`, K = 2 x byte rows) of
    # one decode step (4 slots, C = 1)
    packed_ws = []

    def walk(t):
        if isinstance(t, dict):
            for k, v in t.items():
                if k.endswith("_q"):
                    packed_ws.append(PackedCodes(v, 2 * v.shape[0]))
                else:
                    walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(srv_on.params)
    check(len(packed_ws) == 169, f"phase 3t: {len(packed_ws)} packed "
          "weights, expected 169")
    xs = {k: torch.zeros(4, 1, k, device=dev)
          for k in {w.k for w in packed_ws}}
    macro = cfg.cim.macro
    KERNEL_COUNTERS.reset()
    per_step = []
    for _ in range(7):
        t = time.perf_counter()
        for w in packed_ws:
            engine._record_dispatch("cuda_packed", xs[w.k], w, macro)
        per_step.append(time.perf_counter() - t)
    KERNEL_COUNTERS.reset()
    kc_us = statistics.median(per_step[2:]) * 1e6
    kc_share = kc_us / (tel.step_wall.percentile(50) * 1e6)
    log(f"phase 3t ({card}): KERNEL_COUNTERS host cost {kc_us:.1f} us per "
        f"decode step (169 count_backend + add_site_energy calls, median "
        f"of 5 steps), {100 * kc_share:.4f} % of the median step wall")
    del srv_on, srv_off, srv, packed_ws, xs

    # ---- phase 4: --cim bp serve (B2) ------------------------------------
    server = Server(params, cfg, ServingConfig(
        paged=True, attn="kernel", n_slots=4, max_len=256,
        prefill_chunk=16), device=dev)
    counts = short_serve(server, prompts, "phase 4: --cim bp")
    main_launches["B2"] = counts["cim_mvm_grouped"]
    check(main_launches["B2"] > 0, "B2 was not launched on the --cim bp path")
    decode_breakdown(server, "phase 4: --cim bp")
    del server

    # ---- phase 4b: the seeded NOISY converter (B6, then B5) --------------
    # built as the reference's serve.py --cim bp-noisy builds it
    noisy = CIMConfig(enabled=True, noise_seed=0)
    noisy = dataclasses.replace(noisy, macro=dataclasses.replace(
        noisy.macro, sim_level=SimLevel.NOISY))
    ncfg = cfg.replace(cim=noisy)
    server = Server(params, ncfg, serving, device=dev)
    counts, _ = serve_mix(server, prompts, "phase 4b: NOISY prequant")
    for name, n in (("B6", counts["cim_mvm_grouped_noisy_packed"]),
                    ("B3", counts["paged_attn_call"]),
                    ("B3+B4", counts["decode_write_attend_call"])):
        check(n > 0, f"{name} was not launched on the NOISY prequant serve")
    main_launches["B6"] = counts["cim_mvm_grouped_noisy_packed"]
    check_steps(server, "phase 4b: NOISY prequant")
    decode_breakdown(server, "phase 4b: NOISY prequant")
    del server
    server = Server(params, ncfg, ServingConfig(
        paged=True, attn="kernel", n_slots=4, max_len=256,
        prefill_chunk=16), device=dev)
    counts = short_serve(server, prompts, "phase 4b: --cim bp-noisy")
    main_launches["B5"] = counts["cim_mvm_grouped_noisy"]
    check(main_launches["B5"] > 0,
          "B5 was not launched on the --cim bp-noisy path")
    del server

    # ---- phase 5: macro depths other than 144 -----------------------------
    # B2/B5 take every depth the reference takes, B1/B6 every even one;
    # each against its plain version at a layer width
    for n_rows in DEPTHS:
        dkw = dict(n_rows=n_rows, levels=362, gain=1.0,
                   full_scale=225.0 * n_rows)
        dnkw = dict(dkw, sigma=noisy_kw["sigma"])
        for m in (4, 64):
            x, w = codes((m, 2048)), codes((2048, 2048))
            where = f"at n_rows={n_rows} M={m} K=N=2048"
            y2 = cm.cim_mvm_grouped(x, w, **dkw)
            y5 = cm.cim_mvm_grouped_noisy(x, w, seeds[7], **dnkw)
            check(torch.equal(y2, cm.cim_mvm_grouped_plain(x, w, **dkw)),
                  f"B2 differs from its plain version {where}")
            check(torch.equal(y5, cm.cim_mvm_grouped_noisy_plain(
                x, w, seeds[7], **dnkw)),
                f"B5 differs from its plain version {where}")
            if n_rows % 2 == 0:
                wp = ops.pack_codes(w).contiguous()
                check(torch.equal(cm.cim_mvm_grouped_packed(x, wp, **dkw),
                                  y2), f"B1 differs from B2 {where}")
                y6 = cm.cim_mvm_grouped_noisy_packed(x, wp, seeds[7], **dnkw)
                check(torch.equal(y6, y5), f"B6 differs from B5 {where}")
            torch.cuda.synchronize()
            del x, w, y2, y5
    log(f"phase 5: B2, B5 bit-exact vs plain at n_rows {DEPTHS}, M in "
        "{4, 64}, K=N=2048 (NOISY seed 7; tolerance 0); B1 == B2 and B6 == "
        "B5 at the even depths")

    # ---- phase 6: report -------------------------------------------------
    meta = {
        "B1": ("cim_mvm_grouped_packed", "src/repro_torch/kernels/csrc/"
               "cim_mvm.cu", "src/repro/kernels/cim_mvm.py:331"),
        "B2": ("cim_mvm_grouped", "src/repro_torch/kernels/csrc/cim_mvm.cu",
               "src/repro/kernels/cim_mvm.py:366"),
        "B3": ("paged_attn_call", "src/repro_torch/kernels/csrc/"
               "paged_attention.cu", "src/repro/kernels/paged_attention.py:257"),
        "B4": ("decode_write_attend_call", "src/repro_torch/kernels/csrc/"
               "paged_attention.cu", "src/repro/kernels/paged_attention.py:420"),
        "B5": ("cim_mvm_grouped_noisy", "src/repro_torch/kernels/csrc/"
               "cim_mvm.cu", "src/repro/kernels/cim_mvm.py:210"),
        "B6": ("cim_mvm_grouped_noisy_packed", "src/repro_torch/kernels/"
               "csrc/cim_mvm.cu", "src/repro/kernels/cim_mvm.py:253"),
    }
    kernels = []
    for kid, (name, source, replaces) in meta.items():
        r = report[kid]
        kernels.append({"name": f"{kid} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": main_launches[kid],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
