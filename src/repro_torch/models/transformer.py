"""Decoder transformer for paged serving (dense GQA LMs).

Parameters are a dict: {"tok": {"embed", "head"}, "final_norm": {"scale"},
"layers": [per-layer dict, ...]} — the reference's stacked [L, ...] leaves
become one dict of tensors per layer, and its layer scan becomes a Python
loop. The paged KV cache keeps the reference's stacked layout
{"layers": {"k", "v": [L, NB, bs, KH, dh]}}; a layer reads and writes its
slice in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from . import common
from .common import (attention_init, dtype_of, embed_init, embed_lookup,
                     mlp_apply, mlp_init, norm, norm_init, unembed)


def _check_arch(cfg: ModelConfig) -> None:
    if cfg.moe is not None or cfg.mla is not None or cfg.encoder_layers \
            or cfg.cross_attention or cfg.n_image_tokens \
            or cfg.pos_embed != "rope" or cfg.mtp:
        raise NotImplementedError(
            f"arch {cfg.arch!r} needs model features that are not ported "
            "yet (ROADMAP A9)")


def _layer_init(gen, cfg: ModelConfig, *, device) -> dict:
    kw = dict(dtype=dtype_of(cfg), device=device, kind=cfg.norm)
    return {"norm1": norm_init(cfg.d_model, **kw),
            "norm2": norm_init(cfg.d_model, **kw),
            "attn": attention_init(gen, cfg, device=device),
            "ffn": mlp_init(gen, cfg, device=device)}


def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random weights from a torch.Generator seeded with `seed`, made on
    `device` (default: the card). The draws differ from the reference's
    jax.random ones; `registry.params_from_numpy` carries the reference's
    weights across instead."""
    _check_arch(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"tok": embed_init(gen, cfg, device=dev),
            "final_norm": norm_init(cfg.d_model, dtype=dtype_of(cfg),
                                    device=dev, kind=cfg.norm),
            "layers": [_layer_init(gen, cfg, device=dev)
                       for _ in range(cfg.n_layers)]}


def supports_paged(cfg: ModelConfig) -> bool:
    return cfg.mla is None and not cfg.cross_attention


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device=None) -> dict:
    """Physical KV block pools [L, NB, bs, KH, dh] (zeros); NB includes
    the trash block (physical id 0)."""
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged KV serving not implemented for arch {cfg.arch!r}")
    _check_arch(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    return {"layers": {"k": torch.zeros(shape, dtype=dtype_of(cfg),
                                        device=dev),
                       "v": torch.zeros(shape, dtype=dtype_of(cfg),
                                        device=dev)}}


def cow_copy_block(cache: dict, src: int, dst: int) -> dict:
    """Copy one physical block's K/V (every layer) from `src` to `dst`, IN
    PLACE — the copy-on-write primitive behind prefix sharing."""
    for pool in cache["layers"].values():
        pool[:, dst] = pool[:, src]
    return cache


def _layer_paged(lp: dict, h, layer_pool: dict, cfg: ModelConfig, *,
                 index: common.PagedIndex):
    a, _ = common.paged_attention_apply(
        lp["attn"], norm(lp["norm1"], h, cfg), cfg, cache=layer_pool,
        index=index)
    h = h + a
    return h + mlp_apply(lp["ffn"], norm(lp["norm2"], h, cfg), cfg)


def paged_step(params: dict, tokens: torch.Tensor, cache: dict,
               tables: torch.Tensor, lens: torch.Tensor, valid: torch.Tensor,
               cfg: ModelConfig, all_logits: bool = False):
    """One serving step over the paged pool; prefill chunks and decode are
    the same function (decode is C = 1).

    tokens [B, C]; lens [B] tokens already cached per slot; valid [B] new
    tokens this step (0 = idle lane). Writes each slot's new K/V through
    its block table (masked lanes → the trash block), attends per slot, and
    returns (logits, cache) with the cache updated in place. Logits are
    [B, V] at each slot's last valid position, or [B, C, V] with
    `all_logits`.
    """
    b, c = tokens.shape
    block_size = cache["layers"]["k"].shape[2]
    window = tables.shape[1] * block_size
    # the attention kernel's operands are int32 (no copy when the server
    # hands them over as such); torch.gather and index_put take int64
    tables32 = tables.to(torch.int32).contiguous()
    lens32 = lens.to(torch.int32).contiguous()
    tables = tables.long()
    lens = lens.long()
    valid = valid.long()
    positions = lens[:, None] + torch.arange(c, device=tokens.device)[None, :]

    x = embed_lookup(params["tok"], tokens.long(), cfg)
    pos_w = torch.clamp(positions, max=window - 1)
    blk = torch.gather(tables, 1, pos_w // block_size)
    flat_idx = blk * block_size + pos_w % block_size
    in_valid = torch.arange(c, device=tokens.device)[None, :] < valid[:, None]
    flat_idx = torch.where(in_valid & (positions < window), flat_idx,
                           torch.zeros((), dtype=flat_idx.dtype,
                                       device=tokens.device))
    kv_len = lens + valid
    index = common.PagedIndex(positions, flat_idx, tables32, lens32,
                              kv_len.to(torch.int32),
                              flat_idx.to(torch.int32))

    pools = cache["layers"]
    for i, lp in enumerate(params["layers"]):
        x = _layer_paged(lp, x, {"k": pools["k"][i], "v": pools["v"][i]},
                         cfg, index=index)
    x = norm(params["final_norm"], x, cfg)
    if all_logits:
        return unembed(params["tok"], x, cfg), cache          # [B, C, V]
    last = torch.clamp(valid - 1, min=0)
    h_last = x[torch.arange(b, device=x.device), last]
    return unembed(params["tok"], h_last, cfg), cache
