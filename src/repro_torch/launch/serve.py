"""Serving launcher: continuous-batching paged decode over synthetic
requests, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --full --paged \
      --cim bp-prequant

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

Weights are random, drawn from a torch.Generator seeded with --seed.
Prints each request's generated token ids and the tokens per second.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, SMOKES
from repro_torch.core.cim_matmul import CIMConfig
from repro_torch.core.macro import SimLevel
from repro_torch.device import resolve_device
from repro_torch.models import registry
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
    ap.add_argument("--paged", action="store_true", default=True,
                    help="paged-KV engine (the only engine ported; the "
                         "flag is accepted for the reference's command "
                         "lines)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--token-budget", type=int, default=None)
    ap.add_argument("--no-prefix-sharing", action="store_true")
    ap.add_argument("--watermark", type=float, default=None)
    ap.add_argument("--drafter", default="off", metavar="SPEC",
                    help="speculative-decoding drafter (runtime.speculative "
                         "registry): off = plain decode, ngram = "
                         "prompt-lookup self-speculation (model:<name> is "
                         "not ported yet) — the target verifies all drafts "
                         "in one C=spec-k+1 step")
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
    ap.add_argument("--cim", choices=("off", "bp", "bp-noisy",
                                      "bp-prequant"),
                    default="off",
                    help="bp = weights quantized on the fly (kernel B2); "
                         "bp-noisy = the NOISY converter chain with "
                         "noise_seed=0, weights quantized on the fly "
                         "(kernel B5); bp-prequant = nibble-packed stored "
                         "codes (kernel B1)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="torch.Generator seed of the random weights")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
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
    params = registry.init_params(cfg, seed=args.seed, device=device)
    server = Server(params, cfg, ServingConfig.from_flags(args),
                    device=device)

    rng = np.random.RandomState(0)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.randint(4, 17))
        prompt = rng.randint(0, cfg.vocab, size=plen).tolist()
        reqs.append(Request(prompt=prompt, max_new_tokens=args.max_new,
                            sampling=SamplingParams(
                                temperature=args.temperature,
                                top_k=args.top_k,
                                seed=args.sample_seed + i)))
    t0 = time.monotonic()
    for r in reqs:
        server.submit(r)
    server.run_until_drained()
    dt = time.monotonic() - t0
    total_new = sum(len(r.output) for r in reqs)
    for r in reqs:
        print(f"req{r.rid}: prompt_len={len(r.prompt)} -> {r.output}")
    print(f"{args.requests} requests, {total_new} tokens, "
          f"{server.steps_run} steps, {dt:.2f}s "
          f"({total_new / max(dt, 1e-9):.1f} tok/s) on {device}")
    m = server.metrics.summary()
    st = server.alloc.stats
    print(f"attn={args.attn} cim={args.cim} "
          f"decode={m['decode_tok_s']:.1f} tok/s "
          f"prefill={m['prefill_tok_s']:.1f} tok/s | blocks: "
          f"pool={st.num_blocks} peak={st.peak_in_use} | sharing: "
          f"prefix_hit_tokens={m['prefix_hit_tokens']} "
          f"cow_forks={m['cow_forks']} preemptions={m['preemptions']}")
    if args.drafter != "off":
        hist = ",".join(f"{a}:{n}" for a, n in m["accept_hist"].items())
        print(f"speculative: drafter={args.drafter} "
              f"spec_k={server.serving.spec_k} "
              f"verify_steps={m['spec_steps']} "
              f"accept_rate={m['accept_rate']:.2f} "
              f"mean_accept_len={m['mean_accept_len']:.2f} "
              f"accept_hist=[{hist}]")


if __name__ == "__main__":
    main()
