"""One rank of a multi-process test of the port's mesh code on the CPU.

    python tests/_torch_mesh_worker.py CASE RANK WORLD DIR

joins a gloo process group of WORLD ranks through a FileStore in DIR,
runs CASE and writes its outputs to DIR/CASE_RANK.npz (numpy arrays by
name). Started by `_torch_helpers.spawn_ranks`; imports no JAX.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def _xw():
    """The engine tests' operands: x [8, 576], w [576, 64], numpy-seeded."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal((8, 576)).astype(np.float32)
    w = (rng.standard_normal((576, 64)) * 0.1).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def case_engine() -> dict:
    """cim_matmul / cim_matmul_prequant on a 2 x 2 (data, model) mesh, and
    dense_rs's gradients there."""
    from repro_torch.core.cim_matmul import (CIMConfig, cim_matmul,
                                             cim_matmul_prequant,
                                             quantize_weight_offline)
    from repro_torch.core.macro import SimLevel
    from repro_torch.kernels.ops import pack_codes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding

    ideal = CIMConfig(enabled=True)
    noisy = CIMConfig(enabled=True, noise_seed=3, macro=dataclasses.replace(
        CIMConfig().macro, sim_level=SimLevel.NOISY))
    x, w = _xw()
    mesh = make_host_mesh(2, 2, device="cpu")
    sharding.set_mesh(mesh)
    out = {"ideal": cim_matmul(x, w, ideal),
           "noisy": cim_matmul(x, w, noisy),
           "noisy_again": cim_matmul(x, w, noisy),
           "dup": cim_matmul(x, torch.cat([w, w], 1), noisy)}
    for tag, cfg in (("ideal", ideal), ("noisy", noisy)):
        codes, s_w = quantize_weight_offline(w, cfg)
        out[tag + "_u"] = cim_matmul_prequant(x, codes, s_w, cfg)
        out[tag + "_p"] = cim_matmul_prequant(x, pack_codes(codes), s_w, cfg)
    # gradients of x and of the float weights (the STE's weight path)
    # under a fixed upstream gradient: the whole tensors' on every rank,
    # against the same calls without a mesh
    gout = torch.from_numpy(np.random.RandomState(9).standard_normal(
        (8, 64)).astype(np.float32))
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    (cim_matmul(xg, wg, noisy) * gout).sum().backward()
    out["grad_mesh"], out["wgrad_mesh"] = xg.grad, wg.grad
    sharding.set_mesh(None)
    xg.grad = wg.grad = None
    (cim_matmul(xg, wg, noisy) * gout).sum().backward()
    out["grad_nomesh"], out["wgrad_nomesh"] = xg.grad, wg.grad
    out.update(_dense_rs_grads(mesh))
    return out


def _dense_rs_grads(mesh) -> dict:
    """The smoke llama3-8b's prefill at --cim off with dense_rs
    (tp_reduce_scatter) on `mesh` and without a mesh: the logits and the
    gradients of the first layer's float leaves (concatenated)."""
    from repro_torch.configs.registry import SMOKES
    from repro_torch.models import registry, transformer
    from repro_torch.parallel import sharding

    cfg = SMOKES["llama3-8b"].replace(dtype="float32",
                                      tp_reduce_scatter=True)
    params = registry.init_params(cfg, seed=0, device="cpu", max_seq=40)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (4, 16)))
    leaves = [t for t in _leaves(params["layers"][0])
              if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    out = {}
    for tag, m in (("mesh", mesh), ("nomesh", None)):
        sharding.set_mesh(m)
        for t in leaves:
            t.grad = None
        logits = transformer.prefill(params, {"tokens": tokens}, cfg,
                                     max_len=40)[0]
        logits.float().square().mean().backward()
        out["rs_logits_" + tag] = logits.detach()
        out["rs_grads_" + tag] = torch.cat([t.grad.flatten()
                                            for t in leaves])
    sharding.set_mesh(None)
    return out


def case_parallel() -> dict:
    """compressed_psum over 2 ranks, a 2-stage pipeline and dense_rs on a
    1 x 2 (data, model) mesh at --cim off."""
    from repro_torch.configs.registry import SMOKES
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import registry, transformer
    from repro_torch.parallel import sharding
    from repro_torch.parallel.collectives import compressed_psum
    from repro_torch.parallel.pipeline import pipeline_apply

    rank = dist.get_rank()
    out = {}
    rng = np.random.RandomState(100 + rank)
    x = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    err = torch.from_numpy(rng.standard_normal(64).astype(np.float32)
                           * 1e-3)
    y, new_err = compressed_psum(x, dist.group.WORLD, err)
    out.update(psum_x=x, psum_err=err, psum_y=y, psum_new_err=new_err)

    stage_mesh = make_mesh((2,), ("stage",), device="cpu")
    w = torch.from_numpy(np.random.RandomState(5).standard_normal(
        (2, 8, 8)).astype(np.float32))
    xs = torch.from_numpy(np.random.RandomState(6).standard_normal(
        (3, 2, 8)).astype(np.float32))

    def stage(p, h):
        return torch.tanh(h @ p)

    out["pipe"] = pipeline_apply(stage, w, xs, mesh=stage_mesh)
    out["pipe_seq"] = stage(w[1], stage(w[0], xs))

    cfg = SMOKES["llama3-8b"].replace(dtype="float32")
    params = registry.init_params(cfg, seed=0, device="cpu", max_seq=40)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (4, 16)))
    out["logits_plain"] = transformer.prefill(params, {"tokens": tokens},
                                              cfg, max_len=40)[0]
    rs_cfg = cfg.replace(tp_reduce_scatter=True)
    sharding.set_mesh(make_host_mesh(1, 2, device="cpu"))
    out["logits_rs"] = transformer.prefill(params, {"tokens": tokens},
                                           rs_cfg, max_len=40)[0]
    out["logits_mesh"] = transformer.prefill(params, {"tokens": tokens},
                                             cfg, max_len=40)[0]
    leaves = [t for t in _leaves(params["layers"][0])
              if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    transformer.prefill(params, {"tokens": tokens}, rs_cfg,
                        max_len=40)[0].float().square().mean().backward()
    out["rs_grads"] = torch.tensor([
        float(torch.isfinite(t.grad).all()) if t.grad is not None
        else -1.0 for t in leaves])
    sharding.set_mesh(None)
    return out


CASES = {"engine": case_engine, "parallel": case_parallel}


def main() -> None:
    case, rank, world, where = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(where, f"{case}.store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = CASES[case]()
        np.savez(os.path.join(where, f"{case}_{rank}.npz"),
                 **{k: v.detach().numpy() for k, v in out.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
