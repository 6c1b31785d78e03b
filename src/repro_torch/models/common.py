"""Shared model components: CIM-switchable dense layers, norms, RoPE, MLPs,
embeddings and the paged-KV attention step.

Every weight matmul routes through `dense()`, so the analog-CIM execution
mode (core.cim_matmul) is one config switch. Parameters are plain dicts of
tensors; layouts follow the reference package ([d_in, d_out] weights,
[B, T, H, dh] heads) so the tests compare like with like.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.core.cim_matmul import cim_matmul, cim_matmul_prequant
from repro_torch.runtime.telemetry import KERNEL_COUNTERS

Params = dict

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# initializers (an explicit torch.Generator on the target device)
# ---------------------------------------------------------------------------
def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def dense_init(gen, d_in: int, d_out: int, *, dtype, device,
               bias: bool = False, scale: float | None = None,
               name_w: str = "w", name_b: str = "b") -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {name_w: (_normal(gen, (d_in, d_out), device) * scale).to(dtype)}
    if bias:
        p[name_b] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def norm_init(d: int, *, dtype, device, kind: str) -> Params:
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def attention_init(gen, cfg: ModelConfig, *, device) -> Params:
    d, dh = cfg.d_model, cfg.head_dim
    kw = dict(dtype=dtype_of(cfg), device=device, bias=cfg.qkv_bias)
    p = {}
    p.update(dense_init(gen, d, cfg.n_heads * dh, name_w="wq", name_b="bq",
                        **kw))
    p.update(dense_init(gen, d, cfg.n_kv_heads * dh, name_w="wk",
                        name_b="bk", **kw))
    p.update(dense_init(gen, d, cfg.n_kv_heads * dh, name_w="wv",
                        name_b="bv", **kw))
    p.update(dense_init(
        gen, cfg.n_heads * dh, d, dtype=dtype_of(cfg), device=device,
        scale=1.0 / math.sqrt(cfg.n_heads * dh * 2 * cfg.n_layers),
        name_w="wo", name_b="bo"))
    return p


def mlp_init(gen, cfg: ModelConfig, *, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype_of(cfg), device=device)
    p = {}
    if cfg.mlp == "swiglu":
        p.update(dense_init(gen, d, f, name_w="w_gate", **kw))
    p.update(dense_init(gen, d, f, name_w="w_up", **kw))
    p.update(dense_init(gen, f, d, scale=1.0 / math.sqrt(f * 2 * cfg.n_layers),
                        name_w="w_down", **kw))
    return p


def embed_init(gen, cfg: ModelConfig, *, device) -> Params:
    dt = dtype_of(cfg)
    p = {"embed": (_normal(gen, (cfg.vocab, cfg.d_model), device)
                   * 0.02).to(dt)}
    if not cfg.tie_embeddings:
        p["head"] = (_normal(gen, (cfg.d_model, cfg.vocab), device)
                     / math.sqrt(cfg.d_model)).to(dt)
    return p


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------
def dense(p: Params, x: torch.Tensor, cfg: ModelConfig, *, w: str = "w",
          b: str | None = "b") -> torch.Tensor:
    """y = x @ W (+bias) — on the simulated PICO-RAM macro when
    cfg.cim.enabled. CIM runs in f32 (integer-code arithmetic) and casts
    back to the compute dtype; the float path runs in the compute dtype."""
    if cfg.cim.enabled and (w + "_q") in p:
        with quant.act_site(w):
            y = cim_matmul_prequant(x.float(), p[w + "_q"], p[w + "_scale"],
                                    cfg.cim)
        y = y.to(dtype_of(cfg))
    elif cfg.cim.enabled:
        with quant.act_site(w):
            y = cim_matmul(x.float(), p[w].float(), cfg.cim)
        y = y.to(dtype_of(cfg))
    else:
        y = x @ p[w]
    if b is not None and b in p:
        y = y + p[b]
    return y


def norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].float()
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         rope_dims: int) -> torch.Tensor:
    """Rotary embedding on the leading `rope_dims` of the head dim.

    x: [B, T, H, dh]; positions: [B, T] absolute positions. The
    frequencies are exp(−arange(half)·log(theta)/half) in f32, as in the
    reference.
    """
    if rope_dims <= 0:
        return x
    half = rope_dims // 2
    # the Python constant enters the f32 multiply as its f32 value, as the
    # reference's weakly typed constant does
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs          # [B, T, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xpass = x[..., :rope_dims], x[..., rope_dims:]
    x1, x2 = xr[..., :half], xr[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([rot.to(x.dtype), xpass], -1)


def _rope_dims(cfg: ModelConfig) -> int:
    d = int(cfg.head_dim * cfg.rope_pct)
    return d - (d % 2)


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = dense(p, x, cfg, w="w_up", b=None)
    if cfg.mlp == "swiglu":
        gate = dense(p, x, cfg, w="w_gate", b=None)
        h = F.silu(gate) * up
    else:
        h = F.gelu(up)
    return dense(p, h, cfg, w="w_down", b=None)


def embed_lookup(p: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return p["embed"][tokens]


def unembed(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.cim.enabled and "head_q" in p:
        with quant.act_site("head"):
            logits = cim_matmul_prequant(h.float(), p["head_q"],
                                         p["head_scale"], cfg.cim)
    else:
        w = p["embed"].T if cfg.tie_embeddings else p["head"]
        if cfg.cim.enabled:
            with quant.act_site("head"):
                logits = cim_matmul(h.float(), w.float(), cfg.cim)
        else:
            logits = h @ w
    return logits.float()


# ---------------------------------------------------------------------------
# attention over a gathered window (the "exact" backend's math)
# ---------------------------------------------------------------------------
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Single-token attention: q [B,1,H,dh] × caches [B,S,KH,dh] →
    [B,1,H,dh]; kv_len broadcastable to [B, KH, G, S]."""
    b, _, h, dh = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    scores = scores / math.sqrt(dh)
    mask = torch.arange(s, device=q.device)[None, None, None, :] < kv_len
    scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(b, 1, h, dh).to(q.dtype)


def paged_write(pool: torch.Tensor, new: torch.Tensor,
                flat_idx: torch.Tensor) -> torch.Tensor:
    """Scatter per-token K or V rows into a block pool, IN PLACE (the
    reference returned a new array).

    pool [NB, bs, KH, dh]; new [B, C, KH, dh]; flat_idx [B, C] indexes the
    flattened (NB·bs) token-slot axis; masked lanes arrive pointed at the
    trash block (flat index 0), which is never read with non-zero weight.
    """
    nb, bs = pool.shape[:2]
    flat = pool.view(nb * bs, *pool.shape[2:])
    flat[flat_idx.reshape(-1).long()] = new.reshape(
        -1, *new.shape[2:]).to(pool.dtype)
    return pool


def paged_gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Each slot's window from the pool: [B, MB·bs, KH, dh]."""
    b, mb = tables.shape
    win = pool[tables.long()]                       # [B, MB, bs, KH, dh]
    return win.reshape(b, mb * pool.shape[1], *pool.shape[2:])


def paged_prefill_attention(q: torch.Tensor, k_win: torch.Tensor,
                            v_win: torch.Tensor, positions: torch.Tensor,
                            kv_len: torch.Tensor) -> torch.Tensor:
    """Causal attention of a prompt chunk against its gathered window, one
    pass: q [B,C,H,dh] × windows [B,W,KH,dh] → [B,C,H,dh]."""
    b, cq, h, dh = q.shape
    w, kh = k_win.shape[1], k_win.shape[2]
    g = h // kh
    qg = q.reshape(b, cq, kh, g, dh)
    scores = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k_win.float())
    scores = scores / math.sqrt(dh)
    pos_s = torch.arange(w, device=q.device)[None, None, :]
    mask = (pos_s <= positions[:, :, None]) & (pos_s < kv_len[:, None, None])
    scores = torch.where(mask[:, :, None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", p.to(v_win.dtype).float(),
                     v_win.float())
    return o.reshape(b, cq, h, dh).to(q.dtype)


class PagedIndex(NamedTuple):
    """Where one paged step writes and reads, made once per step
    (`transformer.paged_step`) and handed to every layer.

    positions [B, C] and flat_idx [B, C] (the flattened NB·bs row each new
    token goes to, 0 for a masked lane) are int64: RoPE reads positions,
    and `paged_write`'s index_put would convert any other index type with
    a launch of its own. tables [B, MB], lens [B] (the chunk base
    positions[:, 0]), kv_len [B] and flat [B, C] (flat_idx) are int32, as
    the attention kernel reads them, so no layer casts them.
    """

    positions: torch.Tensor
    flat_idx: torch.Tensor
    tables: torch.Tensor
    lens: torch.Tensor
    kv_len: torch.Tensor
    flat: torch.Tensor


def paged_attention_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                          cache: dict, index: PagedIndex):
    """Self-attention over one layer's paged pool {"k", "v"} [NB, bs, KH,
    dh]: project and RoPE this step's tokens at their per-slot positions,
    write them into the pool in place and attend through the
    attention-backend registry. At C = 1 on a backend with a decode entry
    that is one call (on the kernel backend one launch, B4 folded into
    B3); otherwise `paged_write`, then the attention. Returns (y, the layer
    pool).
    """
    from repro_torch.kernels.paged_attention import (choose_attn_backend,
                                                     get_attn_backend,
                                                     paged_attention)
    b, c, _ = x.shape
    dh = cfg.head_dim
    q = dense(p, x, cfg, w="wq", b="bq").reshape(b, c, cfg.n_heads, dh)
    k1 = dense(p, x, cfg, w="wk", b="bk").reshape(b, c, cfg.n_kv_heads, dh)
    v1 = dense(p, x, cfg, w="wv", b="bv").reshape(b, c, cfg.n_kv_heads, dh)
    if cfg.pos_embed == "rope":
        q = rope(q, index.positions, cfg.rope_theta, _rope_dims(cfg))
        k1 = rope(k1, index.positions, cfg.rope_theta, _rope_dims(cfg))
    spec = get_attn_backend(choose_attn_backend(cfg.attn_backend))
    if c == 1 and spec.decode_write_attend is not None:
        # this route bypasses `paged_attention`, which counts the others
        KERNEL_COUNTERS.count_attn(spec.name)
        o = spec.decode_write_attend(q, cache["k"], cache["v"], k1, v1,
                                     index.flat, index.tables, index.lens,
                                     index.kv_len)
    else:
        paged_write(cache["k"], k1, index.flat_idx)
        paged_write(cache["v"], v1, index.flat_idx)
        o = paged_attention(q, cache["k"], cache["v"], index.tables,
                            positions=index.positions, kv_len=index.kv_len,
                            lens=index.lens, backend=cfg.attn_backend)
    y = dense(p, o.reshape(b, c, cfg.n_heads * dh), cfg, w="wo", b="bo")
    return y, cache
