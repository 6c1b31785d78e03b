"""Serve a small model with batched requests on the CIM execution mode.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [--cim] \
        [--paged] [--requests 6] [--slots 3] [--device cpu]

--paged runs the paged-KV engine (block-pool cache, chunked prefill through
the unified step); default is the slot cache. The model is the smoke
internlm2-1.8b, random weights from seed 0. With --cim every matmul runs
on the simulated macro from the float weights (kernel B2 on the card;
--paged adds the paged attention kernel and its decode launch).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.registry import SMOKES
from repro_torch.core.cim_matmul import CIMConfig
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.runtime.server import Request, Server, ServingConfig


def make_server(cim: bool, paged: bool, slots: int, dev) -> Server:
    """The example's Server: the smoke internlm2-1.8b, random weights from
    seed 0, max_len 96, blocks and prefill chunks of 8 tokens."""
    cfg = SMOKES["internlm2-1.8b"]
    if cim:
        cfg = cfg.replace(cim=CIMConfig(enabled=True))
    params = registry.init_params(cfg, seed=0, device=dev, max_seq=96)
    return Server(params, cfg, ServingConfig(
        n_slots=slots, max_len=96, paged=paged, block_size=8,
        prefill_chunk=8), device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cim", action="store_true",
                    help="run every matmul on the simulated macro")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--paged", action="store_true",
                    help="paged-KV engine + chunked prefill")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    server = make_server(args.cim, args.paged, args.slots,
                         resolve_device(args.device))
    cfg = server.cfg

    rng = np.random.RandomState(0)
    reqs = []
    for _ in range(args.requests):
        plen = int(rng.randint(4, 20))
        r = Request(prompt=rng.randint(0, cfg.vocab, size=plen).tolist(),
                    max_new_tokens=8)
        server.submit(r)
        reqs.append(r)

    t0 = time.monotonic()
    server.run_until_drained()
    dt = time.monotonic() - t0
    for r in reqs:
        print(f"req{r.rid} ({len(r.prompt)} prompt tokens) -> {r.output}")
    tokens = sum(len(r.output) for r in reqs)
    print(f"\nmode={'CIM-BP' if args.cim else 'float'}: {tokens} tokens in "
          f"{server.steps_run} batched decode steps, {tokens / dt:.1f} tok/s")
    return reqs


if __name__ == "__main__":
    main()
