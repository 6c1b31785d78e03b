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


# ---------------------------------------------------------------------------
# expert parallelism (models.moe's mesh branches), the a2a exchange, the
# paged attention's head split and the Trainer on a mesh
# ---------------------------------------------------------------------------
MOE_LEGS = ("off", "ideal", "noisy")      # float / packed IDEAL / NOISY
GRAD_LEGS = ("off", "bp")                 # float experts, --cim off / bp


def moe_cfg(leg: str, ep_mode: str = "psum"):
    """The reference's tests/test_moe_distributed.py model (d_model 32, 16
    experts, top-2, capacity factor 8, float32) at a leg."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.core.macro import SimLevel
    cfg = ModelConfig(arch="t", family="moe", n_layers=2, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=16, vocab=64,
                      dtype="float32",
                      moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=16,
                                    capacity_factor=8.0, ep_mode=ep_mode))
    if leg in ("ideal", "bp"):
        cfg = cfg.replace(cim=CIMConfig(enabled=True))
    elif leg == "noisy":
        cfg = cfg.replace(cim=CIMConfig(
            enabled=True, noise_seed=0, macro=dataclasses.replace(
                CIMConfig().macro, sim_level=SimLevel.NOISY)))
    return cfg


def _moe_inputs(where) -> dict:
    with np.load(os.path.join(where, "moe_inputs.npz")) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def _moe_params(inp: dict, leg: str) -> dict:
    from repro_torch.models.quantize import quantize_params
    p = {k: inp[k].clone() for k in ("router", "e_gate", "e_up", "e_down")}
    if leg in ("ideal", "noisy"):
        p = quantize_params(p, moe_cfg(leg), packed=True)
    return p


def _moe_forwards(inp: dict, legs, modes, prefix: str = "") -> dict:
    """moe.apply's (y, aux) at each leg and ep_mode on the prefill x and
    the decode xd, under the active mesh."""
    from repro_torch.models import moe
    out = {}
    for leg in legs:
        p = _moe_params(inp, leg)
        for mode in modes:
            cfg = moe_cfg(leg, mode)
            for shape in ("prefill", "decode"):
                x = inp["x" if shape == "prefill" else "xd"]
                y, aux = moe.apply(p, x, cfg)
                tag = f"{prefix}{leg}_{mode}_{shape}"
                out[tag + "_y"], out[tag + "_aux"] = y, aux
    return out


def _moe_grads(inp: dict, legs, modes) -> dict:
    """Gradients of Σ y·gy + 0.01·aux of moe.apply(train=True) with
    respect to x and the float weights."""
    from repro_torch.models import moe
    out = {}
    names = ("x", "router", "e_gate", "e_up", "e_down")
    for leg in legs:
        for mode in modes:
            leaves = {n: inp[n].clone().requires_grad_() for n in names}
            p = {n: leaves[n] for n in names[1:]}
            y, aux = moe.apply(p, leaves["x"], moe_cfg(leg, mode),
                               train=True)
            ((y * inp["gy"]).sum() + 0.01 * aux).backward()
            tag = f"g_{leg}_{mode}"
            out[tag + "_y"], out[tag + "_aux"] = y, aux
            for n in names:
                out[f"{tag}_{n}"] = leaves[n].grad
    return out


def case_moe() -> dict:
    """The MoE expert-parallel paths on a 2 x 2 (data, model) mesh (psum
    and a2a, prefill and decode, float and packed IDEAL / NOISY experts,
    gradients at off and bp), the same calls without a mesh, and the
    Trainer preempted and resumed on the mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding
    where = sys.argv[4]
    inp = _moe_inputs(where)
    mesh = make_host_mesh(2, 2, device="cpu")
    sharding.set_mesh(mesh)
    out = _moe_forwards(inp, MOE_LEGS, ("psum", "a2a"))
    out.update(_moe_grads(inp, GRAD_LEGS, ("psum", "a2a")))
    sharding.set_mesh(None)
    out.update(_moe_forwards(inp, ("off",), ("psum",), prefix="nomesh_"))
    sharding.set_mesh(mesh)
    out.update(_trainer_on_mesh(where))
    sharding.set_mesh(None)
    return out


def _trainer_on_mesh(where) -> dict:
    """The smoke qwen2-moe (float32, --cim bp, a2a-EP) through the Trainer
    on the active mesh: 4 steps uninterrupted, and 4 steps preempted at
    step 2 and resumed from the step-2 checkpoint (rank 0 writes it
    whole, every rank restores its blocks). The final params of both,
    gathered whole and flattened."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import SMOKES
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.parallel import sharding
    from repro_torch.runtime.trainer import Trainer
    base = SMOKES["qwen2-moe-a2.7b"]
    cfg = base.replace(dtype="float32", cim=CIMConfig(enabled=True),
                       moe=dataclasses.replace(base.moe, ep_mode="a2a"))
    shape = ShapeConfig("tiny", 16, 4, "train")
    tc = TrainConfig(steps=4, lr=1e-3, warmup_steps=1, checkpoint_every=2,
                     log_every=1, keep_checkpoints=2)
    out = {}
    for tag, preempt in (("straight", None), ("resumed", 2)):
        tr = Trainer(cfg, shape, tc, os.path.join(where, "ckpt_" + tag),
                     preempt_at=preempt, device="cpu")
        res = tr.run()
        with torch.no_grad():
            params = sharding.unshard_tree(res["state"]["params"],
                                           tr.specs["params"])
        out["train_" + tag] = torch.cat([t.detach().flatten().float()
                                         for t in tree_leaves(params)])
        out["train_" + tag + "_loss"] = torch.tensor(
            [m["loss"] for m in res["metrics"]])
    return out


def case_moe6() -> dict:
    """A 2 x 3 mesh: "model" (3) does not divide the 16 padded experts, so
    moe.apply takes the batch-sharded fallback (float and packed IDEAL,
    and the float gradients)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding
    inp = _moe_inputs(sys.argv[4])
    sharding.set_mesh(make_host_mesh(2, 3, device="cpu"))
    out = _moe_forwards(inp, ("off", "ideal"), ("psum",))
    out.update(_moe_grads(inp, ("off",), ("psum",)))
    sharding.set_mesh(None)
    return out


def a2a_send(rank: int):
    """Source `rank`'s send buffer of case a2a: [E_pad 4, cap 3, D 5]."""
    return np.random.RandomState(40 + rank).standard_normal(
        (4, 3, 5)).astype(np.float32)


def case_a2a() -> dict:
    """a2a_dispatch then a2a_combine over "model" of a 1 x 2 mesh, and the
    gradient of Σ recv·G through the dispatch."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import collectives, sharding
    rank = dist.get_rank()
    sharding.set_mesh(make_host_mesh(1, 2, device="cpu"))
    send = torch.from_numpy(a2a_send(rank)).requires_grad_()
    recv = collectives.a2a_dispatch(send, "model")
    back = collectives.a2a_combine(recv, "model")
    g = torch.from_numpy(np.random.RandomState(50 + rank).standard_normal(
        tuple(recv.shape)).astype(np.float32))
    (recv * g).sum().backward()
    out = {"recv": recv, "back": back, "send_grad": send.grad, "g": g,
           "combined_g": collectives.a2a_combine(g, "model")}
    # the sharded MVM's gradients on this mesh, where no live axis slices
    # x (K and the rows stay whole, N splits over "model"), and without
    from repro_torch.core.cim_matmul import CIMConfig, cim_matmul
    x, w = (t.requires_grad_() for t in _xw())
    gy = torch.from_numpy(np.random.RandomState(9).standard_normal(
        (8, 64)).astype(np.float32))
    for tag in ("mesh", "nomesh"):
        x.grad = w.grad = None
        (cim_matmul(x, w, CIMConfig(enabled=True)) * gy).sum().backward()
        out["xgrad_" + tag], out["wgrad_" + tag] = x.grad, w.grad
        sharding.set_mesh(None)
    return out


def attn_case(seed: int, *, b=4, kh=4, g=2, dh=32, bs=8, mb=5, c=1):
    """Numpy inputs of the head-split attention: q [B, C, KH·G, dh], NaN
    trash block 0, mixed lengths, lane 0 idle: (q, kp, vp, tables, lens,
    kv_len, new_k, new_v)."""
    rng = np.random.RandomState(seed)
    nb = b * mb + 1
    q = rng.standard_normal((b, c, kh * g, dh)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, kh, dh)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, kh, dh)).astype(np.float32)
    kp[0] = vp[0] = np.nan
    lens = np.array([0] + [rng.randint(0, mb * bs - c + 1)
                           for _ in range(b - 1)], np.int32)
    kvl = (lens + np.array([0] + [c] * (b - 1))).astype(np.int32)
    free = list(range(1, nb))
    rng.shuffle(free)
    tables = np.zeros((b, mb), np.int32)
    for s in range(b):
        for j in range(-(-int(kvl[s]) // bs)):
            tables[s, j] = free.pop()
    new_k = rng.standard_normal((b, c, kh, dh)).astype(np.float32)
    new_v = rng.standard_normal((b, c, kh, dh)).astype(np.float32)
    return q, kp, vp, tables, lens, kvl, new_k, new_v


ATTN_CASES = {"decode": dict(seed=60, c=1), "prefill": dict(seed=61, c=4),
              "gen": dict(seed=62, c=2, dh=20, bs=48, mb=3)}


def case_attn() -> dict:
    """The paged attention on a 2 x 2 mesh (KV heads over "model") and
    without one, through `paged_attention` (kernel and plain backends) at
    three shapes, and one `paged_attention_apply` decode step of the smoke
    internlm2 (the unfused route on the mesh, the one-launch one
    without): outputs and pools."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding
    mesh = make_host_mesh(2, 2, device="cpu")
    out = {}
    for name, kw in ATTN_CASES.items():
        q, kp, vp, tables, lens, kvl, _, _ = (torch.from_numpy(a) for a in
                                              attn_case(**kw))
        pos = lens[:, None] + torch.arange(q.shape[1], dtype=torch.int32)
        for tag, m in (("mesh", mesh), ("nomesh", None)):
            sharding.set_mesh(m)
            for backend in ("kernel", "plain"):
                out[f"{name}_{backend}_{tag}"] = pa.paged_attention(
                    q, kp, vp, tables, positions=pos, kv_len=kvl,
                    backend=backend)
    sharding.set_mesh(None)
    out.update(_layer_step(mesh))
    return out


def _layer_step(mesh) -> dict:
    """One decode step (C = 1) of the smoke internlm2's first attention
    layer through `paged_attention_apply` with and without the mesh, from
    the same pools."""
    from repro_torch.configs.registry import SMOKES
    from repro_torch.models import common, registry
    cfg = SMOKES["internlm2-1.8b"].replace(dtype="float32")
    params = registry.init_params(cfg, seed=0, device="cpu", max_seq=64)
    lp = params["layers"][0]["attn"]
    kh, dh = cfg.n_kv_heads, cfg.head_dim
    rng = np.random.RandomState(63)
    b, bs, mb = 4, 8, 4
    nb = b * mb + 1
    pools = {n: torch.from_numpy(rng.standard_normal(
        (nb, bs, kh, dh)).astype(np.float32)) for n in ("k", "v")}
    tables = torch.from_numpy(np.arange(1, nb, dtype=np.int32).reshape(
        b, mb))
    lens = torch.tensor([0, 5, 17, 30], dtype=torch.int32)
    kvl = lens + torch.tensor([0, 1, 1, 1], dtype=torch.int32)
    pos = lens[:, None].long()
    flat = (tables.long().gather(1, (lens // bs).long()[:, None]) * bs
            + (lens % bs).long()[:, None])
    flat[0] = 0
    index = common.PagedIndex(positions=pos, flat_idx=flat, tables=tables,
                              lens=lens, kv_len=kvl,
                              flat=flat.to(torch.int32))
    x = torch.from_numpy(rng.standard_normal((b, 1, cfg.d_model)).astype(
        np.float32))
    out = {}
    from repro_torch.parallel import sharding
    for tag, m in (("mesh", mesh), ("nomesh", None)):
        sharding.set_mesh(m)
        cache = {n: t.clone() for n, t in pools.items()}
        y, cache = common.paged_attention_apply(lp, x, cfg, cache=cache,
                                                index=index)
        out["layer_y_" + tag] = y
        out["layer_k_" + tag], out["layer_v_" + tag] = cache["k"], cache["v"]
    sharding.set_mesh(None)
    return out


def dryrun_step_cfg(step: str):
    """(cfg, batch, max_len) of the dry-run's collectives test: one slot
    decode step of the smoke internlm2, or of the smoke qwen2-moe under
    a2a-EP, both at IDEAL CIM from packed stored codes."""
    from repro_torch.configs.registry import SMOKES
    from repro_torch.core.cim_matmul import CIMConfig
    arch = {"internlm2": "internlm2-1.8b",
            "qwen2_moe_a2a": "qwen2-moe-a2.7b"}[step]
    cfg = SMOKES[arch].replace(cim=CIMConfig(enabled=True))
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, ep_mode="a2a"))
    return cfg, 4, 16


def dryrun_pipeline(device):
    """The dry-run test's pipeline on the active mesh: 3 microbatches
    through 2 stages over "data" (point-to-point hops and the final
    broadcast)."""
    from repro_torch.parallel import sharding
    from repro_torch.parallel.pipeline import pipeline_apply
    w = torch.ones((2, 8, 8), device=device)
    x = torch.ones((3, 2, 8), device=device)
    return pipeline_apply(lambda p, h: h @ p, w, x,
                          mesh=sharding.get_mesh(), axis="data")


def case_dryrun() -> dict:
    """The collectives (kind, operand bytes) each rank records around the
    dry-run test's decode steps and pipeline on a 2 x 2 (data, model)
    mesh."""
    from repro_torch.analysis import hlo
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.models.quantize import quantize_params
    from repro_torch.parallel import sharding
    sharding.set_mesh(make_host_mesh(2, 2, device="cpu"))
    out = {}
    for step in ("internlm2", "qwen2_moe_a2a"):
        cfg, b, max_len = dryrun_step_cfg(step)
        params = quantize_params(registry.init_params(
            cfg, seed=0, device="cpu", max_seq=max_len), cfg)
        mod = registry.get_module(cfg)
        cache = mod.init_cache(cfg, b, max_len, device="cpu")
        tokens = torch.arange(1, b + 1, dtype=torch.int32).reshape(b, 1)
        with hlo.recording() as rec, torch.no_grad():
            mod.decode_step(params, tokens, cache, cfg)
        out[step + "_kinds"] = torch.tensor(
            [hlo.COLLECTIVES.index(k) for k, _ in rec.collectives],
            dtype=torch.int64)
        out[step + "_bytes"] = torch.tensor(
            [n for _, n in rec.collectives], dtype=torch.int64)
    with hlo.recording() as rec:
        out["pipeline_y"] = dryrun_pipeline("cpu")
    out["pipeline_kinds"] = torch.tensor(
        [hlo.COLLECTIVES.index(k) for k, _ in rec.collectives],
        dtype=torch.int64)
    out["pipeline_bytes"] = torch.tensor([n for _, n in rec.collectives],
                                         dtype=torch.int64)
    sharding.set_mesh(None)
    return out


# ---------------------------------------------------------------------------
# the Trainer's placed state (tests/test_torch_train_sharded.py)
# ---------------------------------------------------------------------------
FSDP_ARCHS = {"internlm2": "internlm2-1.8b", "qwen2moe": "qwen2-moe-a2.7b"}
FSDP_SHAPE = (16, 4)                 # seq, batch of the Trainer runs
# the sharded-vs-whole legs: TrainConfig overrides (AdamW with a clip that
# does not bind is the bit-identical one)
FSDP_LEGS = {"adamw": dict(grad_clip=1e9),
             "clip": dict(grad_clip=1e-3),
             "adafactor": dict(grad_clip=1e9, optimizer="adafactor"),
             "int8": dict(grad_clip=1e9, grad_compression=True)}


def fsdp_tc(**kw):
    from repro_torch.configs.base import TrainConfig
    base = dict(steps=3, lr=1e-3, warmup_steps=1, checkpoint_every=100,
                log_every=1, keep_checkpoints=2)
    base.update(kw)
    return TrainConfig(**base)


def resume_tc():
    """The reference-resume leg's TrainConfig (both packages')."""
    return dict(steps=5, lr=1e-3, warmup_steps=2, checkpoint_every=2,
                log_every=1, keep_checkpoints=2)


def fsdp_cfg(arch: str, cim: bool = False):
    from repro_torch.configs.registry import SMOKES
    from repro_torch.core.cim_matmul import CIMConfig
    cfg = SMOKES[FSDP_ARCHS[arch]].replace(dtype="float32")
    if cim:
        cfg = cfg.replace(cim=CIMConfig(enabled=True))
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, ep_mode="a2a"))
    return cfg


def ref_key(path) -> str:
    """The reference's keystr of a port state leaf (a layer list's index
    dropped: the reference stacks the layers)."""
    return "".join(f"['{k}']" for k in path if not isinstance(k, int))


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _whole_abstract(cfg, tc, max_seq):
    """A train state's whole leaves on meta (params, the optimizer's state
    and, with compression, the f32 error buffers)."""
    from repro_torch.models import registry
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.runtime.trainer import make_optimizer
    params = registry.abstract_params(cfg, max_seq=max_seq)
    state = {"params": params, "opt": make_optimizer(tc).init(params)}
    if tc.grad_compression:
        state["err"] = tree_map(lambda p: torch.empty(
            p.shape, dtype=torch.float32, device="meta"), params)
    return state


def _placement(tag: str, cfg, tc, shape) -> dict:
    """Each leaf's block bounds on this rank under the Trainer's specs,
    keyed by the reference's leaf path (a layer list's leaf once, with its
    [0, L) stack dim; every layer must agree); the Trainer's init_state
    must hold exactly those blocks (the seeded params' values too), and
    its resident bytes must be the dry-run's plan for the same trees."""
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import registry
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.parallel import sharding
    from repro_torch.runtime.trainer import Trainer
    tr = Trainer(cfg, shape, tc, os.path.join(sys.argv[4], "unused"),
                 device="cpu")
    whole = _whole_abstract(cfg, tc, shape.seq_len + 8)
    state = tr.init_state()
    params = registry.init_params(cfg, seed=tc.seed, device="cpu",
                                  max_seq=shape.seq_len + 8)
    out = {}
    for path, t in _walk(whole):
        spec = _get(tr.specs, path)
        bounds = sharding.block_bounds(t.shape, spec)
        block = _get(state, path)
        assert tuple(block.shape) == tuple(hi - lo for lo, hi in bounds), \
            (path, block.shape, bounds)
        if path[0] == "params":
            want = _get(params, path[1:])[tuple(slice(*b) for b in bounds)]
            assert torch.equal(block, want), path
        ints = [i for i, k in enumerate(path) if isinstance(k, int)]
        if ints:
            stack = _get(whole, path[:ints[0]])
            bounds = ((0, len(stack)),) + bounds
        key = f"place|{tag}|{ref_key(path)}"
        b = torch.tensor(bounds, dtype=torch.int64).reshape(-1, 2)
        if key in out:
            assert torch.equal(out[key], b), key
        out[key] = b
    resident = sum(t.numel() * t.element_size()
                   for t in tree_leaves(state))
    planned = dr.per_chip_bytes(dr.Placed(whole, tr.specs))
    out[f"bytes|{tag}"] = torch.tensor([resident, planned])
    return out


def _gathered_params(tr, state):
    """The state's params whole (gathered where placed), flattened."""
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.parallel import sharding
    params = state["params"]
    if tr.specs is not None:
        with torch.no_grad():
            params = sharding.unshard_tree(params, tr.specs["params"])
    return torch.cat([t.flatten().float() for t in tree_leaves(params)])


def _run(tag, cfg, tc, *, shard: bool, preempt=None, ckpt=None) -> dict:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime.trainer import Trainer
    seq, batch = FSDP_SHAPE
    tr = Trainer(cfg, ShapeConfig("tiny", seq, batch, "train"), tc,
                 ckpt or os.path.join(sys.argv[4], f"ck_{tag}"),
                 preempt_at=preempt, device="cpu", shard_state=shard)
    res = tr.run()
    out = {}
    if tr.specs is not None and ckpt is None:
        # the last checkpoint (rank 0's, in the shared directory), read
        # back onto this rank's blocks
        got, _ = tr.mgr.restore(_whole_abstract(cfg, tc, seq + 8),
                                device="cpu", specs=tr.specs)
        out[tag + "_restored"] = torch.tensor(all(
            torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                              tree_leaves(res["state"]))))
    return {**out,
            tag + "_loss": torch.tensor([m["loss"] for m in res["metrics"]]),
            tag + "_gnorm": torch.tensor([m["grad_norm"]
                                          for m in res["metrics"]]),
            tag + "_params": _gathered_params(tr, res["state"]),
            tag + "_blocks": torch.cat([t.flatten().float() for t in
                                        tree_leaves(res["state"])])}


def case_fsdp() -> dict:
    """The Trainer's placed state on a 2 x 2 (data, model) mesh: the
    blocks (smoke internlm2 and qwen2-moe, AdamW and Adafactor with int8
    error feedback, FSDP on and off) and their bytes; the sharded Trainer
    against the whole-state one at each FSDP_LEGS leg and for qwen2-moe
    at --cim bp under a2a-EP; a resume of the reference's checkpoint
    (DIR/ref_ckpt); a preempted sharded run against an uninterrupted
    one."""
    import shutil
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding
    where = sys.argv[4]
    mesh = make_host_mesh(2, 2, device="cpu")
    sharding.set_mesh(mesh)
    out = {"coords": torch.tensor([mesh.get_local_rank("data"),
                                   mesh.get_local_rank("model")])}
    seq, batch = FSDP_SHAPE
    shape = ShapeConfig("tiny", seq, batch, "train")
    for fsdp in (True, False):
        sharding.set_fsdp(fsdp)
        for arch in FSDP_ARCHS:
            for opt in ("adamw", "adafactor"):
                out.update(_placement(
                    f"{arch}|{int(fsdp)}|{opt}", fsdp_cfg(arch),
                    fsdp_tc(optimizer=opt, grad_compression=True), shape))
    sharding.set_fsdp(True)
    cfg = fsdp_cfg("internlm2")
    for leg, kw in FSDP_LEGS.items():
        for shard in (True, False):
            out.update(_run(f"{leg}_{'placed' if shard else 'whole'}", cfg,
                            fsdp_tc(**kw), shard=shard))
    moe = fsdp_cfg("qwen2moe", cim=True)
    for shard in (True, False):
        out.update(_run(f"moe_{'placed' if shard else 'whole'}", moe,
                        fsdp_tc(steps=2, grad_clip=1e9), shard=shard))
    # the reference's step-2 checkpoint, resumed for steps 2-4
    ckpt = os.path.join(where, f"ref_resume_{dist.get_rank()}")
    shutil.copytree(os.path.join(where, "ref_ckpt"), ckpt)
    out.update(_run("resume", cfg, fsdp_tc(**resume_tc()), shard=True,
                    ckpt=ckpt))
    for tag, preempt in (("straight", None), ("preempted", 2)):
        out.update(_run(tag, cfg, fsdp_tc(steps=4, checkpoint_every=2),
                        shard=True, preempt=preempt))
    sharding.set_mesh(None)
    return out


def case_fsdp2() -> dict:
    """The same on a 2 x 1 mesh (FSDP over "data" only): the blocks and
    bytes of the smoke internlm2 with AdamW, and the sharded Trainer
    against the whole-state one (AdamW, a clip that does not bind; and
    with microbatches of 2, accumulated into blocks)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding
    sharding.set_mesh(make_host_mesh(2, 1, device="cpu"))
    seq, batch = FSDP_SHAPE
    cfg = fsdp_cfg("internlm2")
    out = _placement("internlm2|1|adamw", cfg, fsdp_tc(),
                     ShapeConfig("tiny", seq, batch, "train"))
    for shard in (True, False):
        tag = "placed" if shard else "whole"
        out.update(_run(f"adamw_{tag}", cfg, fsdp_tc(**FSDP_LEGS["adamw"]),
                        shard=shard))
        out.update(_run(f"micro_{tag}", cfg, fsdp_tc(
            microbatch=2, **FSDP_LEGS["adamw"]), shard=shard))
    sharding.set_mesh(None)
    return out


CASES = {"engine": case_engine, "parallel": case_parallel, "moe": case_moe,
         "moe6": case_moe6, "a2a": case_a2a, "attn": case_attn,
         "dryrun": case_dryrun, "fsdp": case_fsdp, "fsdp2": case_fsdp2}


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
