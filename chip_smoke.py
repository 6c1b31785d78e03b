#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA device. It imports
only the port (`src/repro_torch`), never JAX or the JAX package, and exits
non-zero without a CUDA device or without the port beside it. Phases, each
of which fails the run when it fails:

  1. the card's name and power limit (nvidia-smi); build the four Hopper
     kernels (one nvcc per source, started together) and time the build;
  2. each kernel against its plain PyTorch version on the card at the main
     path's shapes, from numpy-seeded inputs: B1/B2 (grouped ADC MVM,
     packed/dense) bit-exact at M in {4, 64} over the internlm2-1.8b layer
     and head widths; B3 (paged flash attention) at decode C=1 and prefill
     C=16 with mixed lengths, an idle lane and a NaN trash block, bit-exact
     and finite; B4 (fused decode write) bit-exact. Each is timed with CUDA
     events beside its plain version, a bound and, where one exists, a
     PyTorch library call;
  3. full-width internlm2-1.8b (24 layers, d_model 2048, vocab 92544,
     random weights from a torch.Generator seed) served through `Server`
     with --cim bp-prequant and the kernel attention: 8 requests, two
     sharing a 32-token prefix. Launch counts are reset just before and
     read just after; B1, B3 and B4 must each have launched. Then one
     prefill and one decode `paged_step` with the kernels and with their
     plain versions, which must give identical logits;
  4. a short --cim bp serve, which must launch B2;
  5. a `kernels` JSON line, then the result line.
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

# (name, rows of the decode-step MVM shapes: K, N, launches per step)
DECODE_MVMS = [("wq+wo", 2048, 2048, 48), ("wk+wv", 2048, 1024, 48),
               ("w_gate+w_up", 2048, 8192, 48), ("w_down", 8192, 2048, 24),
               ("head", 2048, 92544, 1)]
PARITY_KN = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048),
             (2048, 92544)]


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
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.kernels import build, cim_mvm as cm, ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import common, registry, transformer
    from repro_torch.runtime.server import Request, Server, ServingConfig

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

    # decode-step timing: M = 4 slots, every MVM shape of one step
    for name, packed in (("B1", True), ("B2", False)):
        tot = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bytes": 0.0,
               "ops": 0.0}
        for label, k, n, count in DECODE_MVMS:
            x = codes((4, k))
            w = codes((k, n))
            w = ops.pack_codes(w).contiguous() if packed else w
            kern = cm.cim_mvm_grouped_packed if packed else cm.cim_mvm_grouped
            plain = cm.cim_mvm_grouped_packed_plain if packed \
                else cm.cim_mvm_grouped_plain
            ws = copies(w)
            args = [(x, wi) for wi in ws]
            t_k = graph_ms(torch, lambda a, b: kern(a, b, **kw), args)
            t_call = time_ms(torch, lambda a, b: kern(a, b, **kw), args)
            t_p = graph_ms(torch, lambda a, b: plain(a, b, **kw), args[:4],
                           reps=3, min_iters=4)
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
            del x, w, ws
        b_bytes = tot["bytes"] / HBM_BYTES_S * 1e3
        b_ops = tot["ops"] / INT_OP_S * 1e3
        report[name] = dict(
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=max(b_bytes, b_ops),
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            library_ms=None, max_abs_err=err[name])
        log(f"  {name} one decode step (169 MVMs): kernel {tot['ms']:.3f} ms "
            f"on the card, {tot['call_ms']:.3f} ms as eager calls, plain "
            f"{tot['plain_ms']:.3f} ms, bound {b_bytes:.3f} ms "
            f"(weight bytes / 3.35 TB/s)")

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

    # B4: fused decode write
    nk = torch.from_numpy(rng.standard_normal((b, 1, kh, dh),
                                              dtype=np.float32)).to(dev)
    nv = torch.from_numpy(rng.standard_normal((b, 1, kh, dh),
                                              dtype=np.float32)).to(dev)
    nk, nv = nk.bfloat16(), nv.bfloat16()
    flat = torch.tensor([[0], [17 * bs + 5], [40 * bs], [63 * bs + 15]],
                        dtype=torch.int32, device=dev)
    k2, v2, k3, v3 = (t.clone() for t in (k_pool, v_pool, k_pool, v_pool))
    pa.fused_write_call(k2, v2, nk, nv, flat)
    pa.fused_write_plain(k3, v3, nk, nv, flat)
    torch.cuda.synchronize()
    same = torch.equal(k2.view(torch.int16), k3.view(torch.int16)) and \
        torch.equal(v2.view(torch.int16), v3.view(torch.int16))
    check(same, "B4 pools differ from its plain version")
    log("phase 2: B4 bit-exact vs plain (tolerance 0)")
    t_k = graph_ms(torch, lambda: pa.fused_write_call(k2, v2, nk, nv, flat),
                   [()], min_iters=100)
    t_call = time_ms(torch, lambda: pa.fused_write_call(k2, v2, nk, nv,
                                                        flat), [()],
                     min_iters=100)
    t_p = graph_ms(torch, lambda: pa.fused_write_plain(k3, v3, nk, nv, flat),
                   [()], min_iters=20)
    rows = flat.reshape(-1).long()
    kflat = k3.view(nb * bs, kh, dh)
    nk2 = nk.reshape(b, kh, dh)
    t_lib = graph_ms(torch, lambda: kflat.index_copy_(0, rows, nk2), [()],
                     min_iters=100)
    b4_bytes = 4 * b * kh * dh * 2       # K and V rows, read once, written once
    report["B4"] = dict(ms=t_k, plain_ms=t_p,
                        bound_ms=b4_bytes / HBM_BYTES_S * 1e3,
                        bound_by="bytes", library_ms=2 * t_lib,
                        max_abs_err=0.0)
    log(f"  B4 B={b} rows of KH={kh} x dh={dh} bf16: kernel {t_k * 1e3:.2f} "
        f"us on the card, {t_call * 1e3:.2f} us per eager call, plain "
        f"{t_p * 1e3:.2f} us, 2x index_copy_ {2 * t_lib * 1e3:.2f} us")
    del k_pool, v_pool, k2, v2, k3, v3, pool_copies, kw_, vw_

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
    reqs = [Request(prompt=p, max_new_tokens=16) for p in prompts]
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
    peak = torch.cuda.max_memory_allocated() / 2**30
    for r in reqs:
        log(f"req{r.rid}: prompt_len={len(r.prompt)} -> {r.output}")
        check(len(r.output) == 16 and all(0 <= t < cfg.vocab
                                          for t in r.output),
              f"req{r.rid}: bad output {r.output}")
    total = sum(len(r.output) for r in reqs)
    m = server.metrics.summary()
    log(f"phase 3: 8 requests, {total} tokens, {server.steps_run} steps, "
        f"{dt:.2f} s ({total / dt:.1f} tok/s), peak memory {peak:.2f} GiB, "
        f"prefix_hit_tokens={m['prefix_hit_tokens']} "
        f"cow_forks={m['cow_forks']} preemptions={m['preemptions']}")
    log(f"phase 3: launches {counts}")
    main_launches = {"B1": counts["cim_mvm_grouped_packed"],
                     "B3": counts["paged_attn_call"],
                     "B4": counts["fused_write_call"]}
    for name, n in main_launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    check(m["prefix_hit_tokens"] >= 32, "the shared prefix was not reused")

    # one prefill + one decode step: kernels vs their plain versions
    def two_steps(step_cfg):
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

    l_k = two_steps(server.cfg)
    plain_cfg = server.cfg.replace(
        attn_backend="plain",
        cim=dataclasses.replace(server.cfg.cim, backend="plain"))
    l_p = two_steps(plain_cfg)
    torch.cuda.synchronize()
    step_err = 0.0
    for a, p_ in zip(l_k, l_p):
        check(a.shape == (4, cfg.vocab) and bool(torch.isfinite(a).all()),
              "paged_step logits malformed")
        step_err = max(step_err, (a[:3] - p_[:3]).abs().max().item())
    log(f"phase 3: paged_step prefill C=16 + decode C=1, kernels vs plain "
        f"versions: max |dlogit| = {step_err} (tolerance 0, bit-exact)")
    check(step_err == 0.0, "kernel and plain paged_step logits differ")

    # where a decode step's time goes: the whole C=1 step captured into a
    # CUDA graph gives the card's time; the eager step adds the host's
    dcache = transformer.init_paged_cache(server.cfg, 4 * 16 + 1, 16,
                                          device=dev)
    dtb = torch.arange(1, 65, dtype=torch.int32, device=dev).reshape(4, 16)
    dlens = torch.tensor([40, 100, 17, 0], device=dev)
    dvalid = torch.tensor([1, 1, 1, 0], device=dev)
    dtok = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab, (4, 1))).to(dev)

    def decode_step():
        transformer.paged_step(server.params, dtok, dcache, dtb, dlens,
                               dvalid, server.cfg)

    t_dev = graph_ms(torch, decode_step, [()], reps=3, min_iters=3)
    t_eager = time_ms(torch, decode_step, [()], reps=3, min_iters=3)
    log(f"phase 3: one decode step (4 slots, C=1): {t_dev:.2f} ms on the "
        f"card (CUDA graph), {t_eager:.2f} ms eager -> the card is idle "
        f"{100 * (1 - t_dev / t_eager):.1f} % of the eager step")
    # the same step under torch.profiler: device time by kernel name
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
                    if str(getattr(e, "device_type", "")).endswith("CUDA")),
                   key=dev_us, reverse=True)
    total_us = sum(dev_us(e) for e in rows_)
    if total_us <= 0:
        log("phase 3: profiler recorded no device time (not measured)")
    else:
        log(f"phase 3: profiled decode step: {total_us / 1e3:.3f} ms of "
            f"kernel time in {sum(e.count for e in rows_)} launches")
    for e in rows_[:12] if total_us > 0 else []:
        log(f"  profile: {dev_us(e) / 1e3:8.3f} ms "
            f"{100 * dev_us(e) / total_us:5.1f} %  x{e.count:<5d} "
            f"{e.key[:100]}")
    del server, dcache

    # ---- phase 4: --cim bp serve (B2) ------------------------------------
    server = Server(params, cfg, ServingConfig(
        paged=True, attn="kernel", n_slots=4, max_len=256,
        prefill_chunk=16), device=dev)
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
        log(f"bp req{r.rid}: -> {r.output}")
        check(len(r.output) == 4, f"bp req{r.rid}: bad output {r.output}")
    log(f"phase 4: --cim bp, 2 requests x 4 tokens in {dt:.2f} s; "
        f"launches {counts}")
    main_launches["B2"] = counts["cim_mvm_grouped"]
    check(main_launches["B2"] > 0, "B2 was not launched on the --cim bp path")

    # ---- phase 5: report -------------------------------------------------
    meta = {
        "B1": ("cim_mvm_grouped_packed", "src/repro_torch/kernels/csrc/"
               "cim_mvm.cu", "src/repro/kernels/cim_mvm.py:331"),
        "B2": ("cim_mvm_grouped", "src/repro_torch/kernels/csrc/cim_mvm.cu",
               "src/repro/kernels/cim_mvm.py:366"),
        "B3": ("paged_attn_call", "src/repro_torch/kernels/csrc/"
               "paged_attention.cu", "src/repro/kernels/paged_attention.py:257"),
        "B4": ("fused_write_call", "src/repro_torch/kernels/csrc/"
               "paged_attention.cu", "src/repro/kernels/paged_attention.py:420"),
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
