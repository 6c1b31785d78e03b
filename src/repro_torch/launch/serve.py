"""Serving launcher: continuous-batching decode over synthetic requests,
on the card by default. Without --paged it serves through the slot engine
(one prefill per request, a shared [slots, max-len] cache), as the
reference's launcher does.

  # the slot engine on the smoke-size model on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      [--cim bp-prequant]

  # deepseek-v3 (MLA with the absorbed latent decode, three leading dense
  # layers, 256 routed experts): the slot engine only (--paged raises);
  # --cim bp / bp-noisy runs the routed experts through B2 / B5's
  # expert-batched entry (bp-prequant cannot decode: the absorbed decode
  # reads float weights, as in the reference)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b \
      --smoke --device cpu [--cim bp|bp-noisy]

  # the rest of the decoder archs: internvl2-26b (the dense decoder behind
  # an image prefix; served as text, on either engine), rwkv6-7b and
  # zamba2-2.7b (recurrent state caches: the slot engine only, --paged
  # raises, as in the reference)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --smoke --device cpu [--cim bp-prequant|bp-noisy]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b \
      --smoke --device cpu --paged --cim bp-prequant

  # whisper-large-v3 is accepted, as by the reference's launcher, and its
  # first prefill raises KeyError('frames'...): the Servers pass tokens
  # only and its encoder reads frame embeddings, so whisper runs through
  # models.transformer.prefill / decode_step with batch["frames"]
  # (--paged raises NotImplementedError: a cross-attention cache)

  # the paged-KV engine at full width on the card; --cim bp-prequant
  # quantizes every layer as soon as it is made, at any size (so
  # internvl2-26b's ~37.5 GB of bf16 weights are never held whole), except
  # under --act-scale static or --precision-manifest, which quantize the
  # whole float model once the Server has its site grids
  PYTHONPATH=src python -m repro_torch.launch.serve --full --paged \
      --cim bp-prequant
  PYTHONPATH=src python -m repro_torch.launch.serve --full \
      --arch zamba2-2.7b --cim bp-prequant

  # smoke-size model on the CPU, the plain PyTorch versions of the kernels
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --paged \
      --cim bp-prequant --device cpu

  # the stochastic (NOISY) converter chain, seeded: kernel B5
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --paged \
      --cim bp-noisy --device cpu

  # speculative decoding: the ngram drafter proposes --spec-k tokens per
  # decode lane, verified in one C = spec_k + 1 step; seeded sampling
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --paged \
      --device cpu --drafter ngram --spec-k 3 --temperature 0.7 --top-k 8

  # parallel samples and the prefix-trie watermark sweep; telemetry
  # export: Perfetto-loadable Chrome trace (one track per slot + a
  # scheduler track), Prometheus text snapshot, JSONL event log;
  # --arrival poisson paces seeded exponential inter-arrival gaps in real
  # time instead of submitting every request at once
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --paged \
      --device cpu --n-samples 2 --trie-watermark 0.5 \
      --trace-out trace.json --metrics-out metrics.prom \
      [--events-out events.jsonl] \
      [--arrival poisson --arrival-rate 8 --arrival-seed 0]

  # a kernel tuning cache (kernels.autotune): the launch knobs of B1/B2/
  # B5/B6 and B3's split, and, without --block-size, a tuned pool block
  # size that divides --max-len
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --paged \
      --cim bp-prequant --device cpu --tune-cache tune.json

  # the mesh-sharded CIM engine (parallel.sharding): every rank builds the
  # same weights from --seed, each CIM MVM runs per shard (K over "data",
  # N over "model"), rank 0 prints; one process is a 1-rank mesh (on the
  # card too), torchrun gives more (gloo on the CPU)
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --paged \
      --cim bp-prequant --mesh host
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --smoke --paged --cim bp-prequant --mesh host --device cpu

  # a static calibrated DAC grid (calibrated on a 2 x 16-token batch), or
  # a mixed-precision manifest's per-site grids and ADC levels
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --paged \
      --cim bp-prequant --act-scale static --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --paged \
      --cim bp-prequant --precision-manifest precision_manifest.json \
      --device cpu

Weights are random, drawn from a torch.Generator seeded with --seed.
Prints each request's generated token ids, the tokens per second, the
TTFT / latency and SLO lines and the KV bytes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, SMOKES
from repro_torch.core.cim_matmul import CIMConfig
from repro_torch.core.macro import SimLevel
from repro_torch.device import resolve_device
from repro_torch.kernels import autotune
from repro_torch.models import registry
from repro_torch.models.quantize import quantize_params
from repro_torch.runtime import obs
from repro_torch.runtime.server import Request, Server, ServingConfig
from repro_torch.runtime.speculative import SamplingParams


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the smoke-scale config (default on)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="use the full config instead of the smoke scale")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--paged", action="store_true",
                    help="paged-KV engine: block-pool cache + chunked "
                         "prefill through the unified step (decode is "
                         "C = 1); without it the slot engine serves")
    ap.add_argument("--block-size", type=int, default=None,
                    help="tokens per KV block (paged engine); default 16, "
                         "or the tuned layout when --tune-cache has one "
                         "for this window")
    ap.add_argument("--tune-cache", default=None, metavar="PATH",
                    help="kernel tuning cache (kernels.autotune), exported "
                         "as $REPRO_TUNE_CACHE so the MVM and attention "
                         "dispatchers take its launch knobs, and consulted "
                         "for a tuned paged-pool block size when "
                         "--block-size is not given")
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--token-budget", type=int, default=None)
    ap.add_argument("--no-prefix-sharing", action="store_true")
    ap.add_argument("--watermark", type=float, default=None)
    ap.add_argument("--n-samples", type=int, default=1,
                    help="parallel samples per request: one shared "
                         "prefill, N continuations forked copy-on-write "
                         "off the cached prefix")
    ap.add_argument("--trie-watermark", type=float, default=None,
                    help="prefix-cache capacity fraction: when the trie "
                         "caches more than this fraction of the pool, an "
                         "LRU sweep (run every step, idle ones included) "
                         "drains it to half that (default: no sweep)")
    ap.add_argument("--drafter", default="off", metavar="SPEC",
                    help="speculative-decoding drafter (runtime.speculative "
                         "registry; paged engine): off = plain decode, "
                         "ngram = prompt-lookup self-speculation, "
                         "model:<name> = a small draft model from "
                         "configs.registry — the target verifies all "
                         "drafts in one C=spec-k+1 step")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="drafted tokens per decode lane per verify step "
                         "(default 4; only meaningful with --drafter)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for the synthetic requests "
                         "(0 = greedy; >0 samples the softmax with a "
                         "per-request seeded PRNG)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k highest logits "
                         "(0 = full vocab; needs --temperature > 0)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="base sampling seed; request i uses seed + i")
    ap.add_argument("--attn", choices=("auto", "exact", "kernel"),
                    default="auto",
                    help="paged attention backend: kernel = Hopper kernels "
                         "B3/B4, exact = window gather + one-pass softmax, "
                         "auto = kernel")
    ap.add_argument("--act-scale", choices=("dynamic", "static"),
                    default="dynamic",
                    help="static = calibrate one fixed input-DAC grid "
                         "(analysis.calibrate over a synthetic 2 x 16-token "
                         "batch) so each lane's CIM quantization is "
                         "independent of batch composition; needs --cim")
    ap.add_argument("--precision-manifest", default=None, metavar="PATH",
                    dest="precision_manifest",
                    help="mixed-precision deployment manifest "
                         "(analysis.precision_search JSON): per-call-site "
                         "static grid, ADC levels, scheme and per-channel "
                         "overrides; a missing/malformed/stale file warns "
                         "and serves uniform defaults; needs --cim")
    ap.add_argument("--cim", choices=("off", "bp", "bp-noisy",
                                      "bp-prequant"),
                    default="off",
                    help="bp = weights quantized on the fly (kernel B2); "
                         "bp-noisy = the NOISY converter chain with "
                         "noise_seed=0, weights quantized on the fly "
                         "(kernel B5); bp-prequant = nibble-packed stored "
                         "codes (kernel B1)")
    ap.add_argument("--arrival", choices=("batch", "poisson"),
                    default="batch",
                    help="request arrival process: batch = submit all up "
                         "front, poisson = seeded exponential inter-arrival "
                         "gaps paced in real time")
    ap.add_argument("--arrival-rate", type=float, default=8.0,
                    help="mean requests/s for --arrival poisson")
    ap.add_argument("--arrival-seed", type=int, default=0,
                    help="numpy RNG seed for the arrival gaps")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the request "
                         "lifecycle + scheduler steps (load it at "
                         "https://ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a Prometheus text-exposition snapshot "
                         "(TTFT/ITL/accept-length/step-wall histograms, "
                         "event + kernel counters, pool gauges)")
    ap.add_argument("--events-out", default=None, metavar="PATH",
                    help="write the raw structured event log + step "
                         "snapshots as JSONL")
    ap.add_argument("--mesh", choices=("none", "host"), default="none",
                    help="host = shard every CIM MVM over a data x model "
                         "mesh of the world's ranks (launch.mesh: one "
                         "process is a 1-rank mesh; torchrun starts more; "
                         "nccl on the card, gloo on the CPU)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="torch.Generator seed of the random weights")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.tune_cache:
        os.environ[autotune.CACHE_ENV] = args.tune_cache
    if args.block_size is None:
        args.block_size = 16
        if args.paged and args.tune_cache:
            tuned = autotune.lookup("paged_attn",
                                    autotune.attn_family(args.max_len, 1),
                                    "kernel", autotune.platform_of(device))
            if tuned and isinstance(tuned.get("block_size"), int) \
                    and args.max_len % tuned["block_size"] == 0:
                args.block_size = tuned["block_size"]
                print(f"tuned paged-pool block_size={args.block_size} "
                      f"(from {args.tune_cache})")
    if args.mesh == "none":
        return _serve(ap, args, device, lead=True)
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_smoke_mesh
    from repro_torch.parallel import sharding
    owned = not dist.is_initialized()
    mesh, data, model = make_host_smoke_mesh(device=device)
    if device.type == "cuda":       # this rank's card (LOCAL_RANK)
        device = torch.device("cuda", torch.cuda.current_device())
    sharding.set_mesh(mesh)
    lead = dist.get_rank() == 0
    if lead:
        print(f"serving on host mesh data={data} model={model}")
    try:
        return _serve(ap, args, device, lead=lead)
    finally:
        sharding.set_mesh(None)
        if owned:
            dist.destroy_process_group()


def _serve(ap, args, device, *, lead: bool):
    """Build the model and the Server from the seed, serve the synthetic
    requests and, on the lead rank, print the streams and the metrics
    lines and write the telemetry files."""
    def say(*a, **kw):
        if lead:
            print(*a, **kw)

    # float matmuls (--cim off) run in full f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = (SMOKES if args.smoke else ARCHS)[args.arch]
    if args.cim == "bp-noisy":
        cim = CIMConfig(enabled=True, noise_seed=0)
        cfg = cfg.replace(cim=dataclasses.replace(
            cim, macro=dataclasses.replace(cim.macro,
                                           sim_level=SimLevel.NOISY)))
    elif args.cim != "off":
        cfg = cfg.replace(cim=CIMConfig(enabled=True))
    layer_fn = None
    if args.cim == "bp-prequant" and args.act_scale == "dynamic" \
            and not args.precision_manifest:
        def layer_fn(lp):
            return quantize_params(lp, cfg)
    params = registry.init_params(cfg, seed=args.seed, device=device,
                                  layer_fn=layer_fn, max_seq=args.max_len)
    if args.precision_manifest and args.cim == "off":
        ap.error("--precision-manifest needs a --cim mode")
    act_scale = act_zero_point = None
    if args.act_scale == "static":
        if args.cim == "off":
            ap.error("--act-scale static needs a --cim mode")
        from repro_torch.analysis.calibrate import calibrate_act_scale
        cal_rng = np.random.RandomState(7)
        cal_tokens = cal_rng.randint(0, cfg.vocab, size=(2, 16))
        cal = calibrate_act_scale(params, cal_tokens, cfg)
        act_scale = cal["scale"]
        act_zero_point = cal["zero_point"]
        say(f"calibrated static act_scale={act_scale:.6f} "
            f"zero_point={act_zero_point:.0f} "
            f"(max span {cal['span']:.4f} over {len(cal['spans'])} "
            f"matmul sites)")
    serving = ServingConfig.from_flags(args, act_scale=act_scale,
                                       act_zero_point=act_zero_point)
    server = Server(params, cfg, serving, device=device)

    rng = np.random.RandomState(0)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.randint(4, 17))
        prompt = rng.randint(0, cfg.vocab, size=plen).tolist()
        reqs.append(Request(prompt=prompt, max_new_tokens=args.max_new,
                            n_samples=args.n_samples,
                            sampling=SamplingParams(
                                temperature=args.temperature,
                                top_k=args.top_k,
                                seed=args.sample_seed + i)))
    due = None
    if args.arrival == "poisson":
        arr_rng = np.random.RandomState(args.arrival_seed)
        gaps = arr_rng.exponential(1.0 / max(args.arrival_rate, 1e-9),
                                   size=len(reqs))
        due = np.cumsum(gaps)
        say(f"arrival=poisson rate={args.arrival_rate}/s "
            f"seed={args.arrival_seed} span={due[-1]:.2f}s")
    t0 = time.monotonic()
    if due is None:
        for r in reqs:
            server.submit(r)
    else:
        # real-time pacing: submit each request at its arrival time; step
        # the server while waiting so in-flight lanes keep decoding
        # between arrivals (idle gaps just sleep)
        i = 0
        while i < len(reqs):
            now = time.monotonic() - t0
            if now >= due[i]:
                server.submit(reqs[i])
                i += 1
            elif any(r is not None for r in server.slot_req):
                server.step()
            else:
                time.sleep(min(float(due[i]) - now, 0.002))
    server.run_until_drained()
    dt = time.monotonic() - t0
    done = [s for r in reqs for s in (r, *r.samples)]
    total_new = sum(len(r.output) for r in done)
    for r in done:
        say(f"req{r.rid}: prompt_len={len(r.prompt)} -> {r.output}")
    say(f"{args.requests} requests x{args.n_samples}, {total_new} tokens, "
        f"{server.steps_run} steps, {dt:.2f}s "
        f"({total_new / max(dt, 1e-9):.1f} tok/s) on {device}")
    m = server.metrics.summary()
    kv = server.kv_cache_bytes()
    say(f"engine={'paged' if args.paged else 'slots'} "
        f"attn={args.attn if args.paged else '-'} cim={args.cim} "
        f"decode={m['decode_tok_s']:.1f} tok/s "
        f"prefill={m['prefill_tok_s']:.1f} tok/s "
        f"kv_bytes total={kv['total']} in_use={kv['in_use']}")
    ttft = [r.ttft_s for r in done]
    lat = [r.latency_s for r in done]
    say(f"ttft p50={np.median(ttft) * 1e3:.1f}ms "
        f"max={max(ttft) * 1e3:.1f}ms | latency "
        f"p50={np.median(lat) * 1e3:.1f}ms max={max(lat) * 1e3:.1f}ms")
    if args.paged:
        st = server.alloc.stats
        say(f"blocks: pool={st.num_blocks} peak={st.peak_in_use} "
            f"shared={st.shared} allocs={st.total_allocs} "
            f"frees={st.total_frees}")
        say(f"sharing: prefix_hit_tokens={m['prefix_hit_tokens']} "
            f"cow_forks={m['cow_forks']} preemptions={m['preemptions']} "
            f"peak_active={m['peak_active']} "
            f"trie_sweep_freed={m['trie_sweep_freed']}")
        if args.drafter != "off":
            hist = ",".join(f"{a}:{n}" for a, n in m["accept_hist"].items())
            say(f"speculative: drafter={args.drafter} "
                f"spec_k={server.serving.spec_k} "
                f"verify_steps={m['spec_steps']} "
                f"accept_rate={m['accept_rate']:.2f} "
                f"mean_accept_len={m['mean_accept_len']:.2f} "
                f"accept_hist=[{hist}]")

    tel = server.telemetry
    if tel.enabled and tel.ttft.n:
        say(f"slo: ttft p50={tel.ttft.percentile(50) * 1e3:.1f}ms "
            f"p99={tel.ttft.percentile(99) * 1e3:.1f}ms | "
            f"itl p50={tel.itl.percentile(50) * 1e3:.1f}ms "
            f"p99={tel.itl.percentile(99) * 1e3:.1f}ms | "
            f"step_wall p50={tel.step_wall.percentile(50) * 1e3:.1f}ms")
    if not lead:
        return
    if args.trace_out:
        doc = obs.chrome_trace(tel)
        with open(args.trace_out, "w") as f:
            json.dump(doc, f)
        say(f"wrote {args.trace_out} ({len(doc['traceEvents'])} trace "
            "events) — load at https://ui.perfetto.dev")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(obs.prometheus_text(tel, server))
        say(f"wrote {args.metrics_out}")
    if args.events_out:
        n = obs.write_events_jsonl(tel, args.events_out)
        say(f"wrote {args.events_out} ({n} lines)")

if __name__ == "__main__":
    main()
