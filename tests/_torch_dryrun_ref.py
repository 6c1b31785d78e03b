"""The reference side of tests/test_torch_dryrun.py, in a process of its
own: jax fixes its device count at first use, and the reference's
production meshes need 512 placeholder host devices.

    python tests/_torch_dryrun_ref.py OUT.json

For every arch at full width it writes the abstract trees' leaves (path,
shape, dtype) — params, offline-quantized params, the train state's
optimizer state, the inputs of every shape and the decode caches — the
parameter counts and model FLOPs of every shape (float and quantized
params), and, on the (data 16, model 16) and (pod 2, data 16, model 16)
meshes with FSDP on and off, every leaf's partition spec and the per-chip bytes of
each cell's arguments (params or the train state, batch, cache; without
the train step's 8-byte PRNG key). It also runs the reference's
`run_cell` on a smoke config (the JSON keys of an ok cell) and on the
skipped cells. Nothing is compiled but that one smoke cell.
"""
from __future__ import annotations

import os
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=512 "
                           + os.environ.get("XLA_FLAGS", ""))
os.environ["JAX_PLATFORMS"] = "cpu"

import json  # noqa: E402
import math  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.analysis import roofline  # noqa: E402
from repro.configs.base import SHAPES, TrainConfig  # noqa: E402
from repro.configs.registry import ARCHS, SMOKES, cell_is_runnable  # noqa: E402
from repro.launch import dryrun as dr  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.models.quantize import abstract_quantized_params  # noqa: E402
from repro.parallel import sharding  # noqa: E402
from repro.runtime.trainer import make_train_step  # noqa: E402

CIMS = ("off", "bp-prequant")


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def leaves(tree) -> list:
    """[(path, shape, dtype)] of an abstract tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [("/".join(_key(k) for k in kp), list(s.shape), str(s.dtype))
            for kp, s in flat]


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def specs(tree) -> dict:
    """{path: spec entries, one per dim} of a tree with NamedShardings."""
    out = {}
    for kp, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = tuple(s.sharding.spec)
        spec = spec + (None,) * (len(s.shape) - len(spec))
        out["/".join(_key(k) for k in kp)] = [_entry(e) for e in spec]
    return out


def chip_bytes(tree) -> int:
    total = 0
    for s in jax.tree.leaves(tree):
        shard = s.sharding.shard_shape(s.shape)
        total += math.prod(shard) * np.dtype(s.dtype).itemsize
    return total


def _max_seq(shape) -> int:
    return shape.seq_len + (8 if shape.kind != "train" else 0)


def main(out_path: str) -> None:
    out = {"abstract": {}, "counts": {}, "placed": {}, "cells": {}}
    meshes = {"single": make_production_mesh(multi_pod=False),
              "multi": make_production_mesh(multi_pod=True)}
    for arch, cfg in sorted(ARCHS.items()):
        mod = registry.get_module(cfg)
        learned = cfg.pos_embed == "learned"
        params = {}            # by max_seq (only learned positions differ)

        def params_for(shape):
            ms = _max_seq(shape) if learned else 0
            if ms not in params:
                params[ms] = registry.abstract_params(cfg, max_seq=ms)
            return params[ms]

        quantized = {}

        def quantized_for(shape):
            ms = _max_seq(shape) if learned else 0
            if ms not in quantized:
                quantized[ms] = abstract_quantized_params(params_for(shape),
                                                          cfg)
            return quantized[ms]

        dec = SHAPES["decode_32k"]
        p0 = params_for(dec)
        q0 = quantized_for(dec)
        tc = TrainConfig(optimizer=dr.choose_optimizer(p0))
        _, opt = make_train_step(cfg, tc)
        o0 = jax.eval_shape(opt.init, params_for(SHAPES["train_4k"]))
        batches = {n: registry.input_specs(cfg, s) for n, s in SHAPES.items()}
        caches = {n: jax.eval_shape(
            lambda s=s: mod.init_cache(cfg, s.global_batch, s.seq_len))
            for n, s in SHAPES.items() if s.kind == "decode"}
        counts = {}
        for n, s in SHAPES.items():
            for cim in CIMS:
                p = (quantized_for if cim == "bp-prequant"
                     else params_for)(s)
                counts[f"{n}/{cim}"] = [
                    roofline.count_params(p),
                    roofline.count_active_params(p, cfg),
                    roofline.model_flops(cfg, s, p)]
        out["counts"][arch] = counts
        out["abstract"][arch] = {
            "params": leaves(p0), "quantized": leaves(q0),
            "opt": leaves(o0), "optimizer": tc.optimizer,
            "inputs": {n: leaves(b) for n, b in batches.items()},
            "caches": {n: leaves(c) for n, c in caches.items()}}
        placed = out["placed"][arch] = {}
        for mesh_kind, mesh in meshes.items():
            for fsdp in (True, False):
                sharding.set_mesh(mesh)
                sharding.set_fsdp(fsdp)
                try:
                    tag = f"{mesh_kind}-{'fsdp' if fsdp else 'nofsdp'}"
                    p_sh = dr.params_shardings(p0, mesh)
                    o_sh = dr._with_shardings(
                        o0, sharding.tree_param_specs(o0), mesh)
                    b_sh = {n: dr.batch_shardings(b, mesh)
                            for n, b in batches.items()}
                    c_sh = {n: dr.cache_shardings(c, mesh)
                            for n, c in caches.items()}
                    rec = {"params": specs(p_sh),
                           "quantized": specs(dr.params_shardings(q0, mesh)),
                           "opt": specs(o_sh),
                           "inputs": {n: specs(b) for n, b in b_sh.items()},
                           "caches": {n: specs(c) for n, c in c_sh.items()},
                           "bytes": {}}
                    for n, s in SHAPES.items():
                        if not cell_is_runnable(cfg, s)[0]:
                            continue
                        for cim in CIMS:
                            if cim == "bp-prequant" and s.kind == "train":
                                continue
                            p = (quantized_for if cim == "bp-prequant"
                                 else params_for)(s)
                            total = chip_bytes(dr.params_shardings(p, mesh))
                            total += chip_bytes(b_sh[n])
                            if s.kind == "train":
                                total += chip_bytes(o_sh)
                            if s.kind == "decode":
                                total += chip_bytes(c_sh[n])
                            rec["bytes"][f"{n}/{cim}"] = total
                    placed[tag] = rec
                finally:
                    sharding.set_mesh(None)
                    sharding.set_fsdp(True)
    # run_cell: an ok smoke cell's keys, the skipped cells' reasons
    ok = dr.run_cell("internlm2-1.8b", "decode_32k", "single",
                     cfg_override=SMOKES["internlm2-1.8b"])
    out["cells"]["ok"] = {
        "cell": ok["cell"], "status": ok["status"], "keys": sorted(ok),
        "memory_keys": sorted(ok.get("memory_analysis", {})),
        "roofline_keys": sorted(ok.get("roofline", {})),
        "error": ok.get("error")}
    for name, args, kw in (
            ("long", ("llama3-8b", "long_500k", "single"), {}),
            ("prequant_train", ("internlm2-1.8b", "train_4k", "single"),
             {"cim": "bp-prequant"}),
            ("ep_dense", ("llama3-8b", "decode_32k", "multi"),
             {"ep": "a2a"}),
            ("xp_long", ("internlm2-1.8b", "long_500k", "multi"),
             {"cim": "bp", "analysis": "extrapolate"})):
        out["cells"][name] = dr.run_cell(*args, **kw)
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
