"""Shared model components: CIM-switchable dense layers, norms, RoPE, MLPs,
embeddings, the slot engine's chunked attention and the paged-KV attention
step.

Every weight matmul routes through `dense()`, so the analog-CIM execution
mode (core.cim_matmul) is one config switch. Parameters are plain dicts of
tensors; layouts follow the reference package ([d_in, d_out] weights,
[B, T, H, dh] heads) so the tests compare like with like.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.core.cim_matmul import (cim_matmul, cim_matmul_prequant,
                                         cim_matmul_ste)
from repro_torch.runtime.telemetry import KERNEL_COUNTERS

Params = dict
# XLA:CPU evaluates a cumulative sum in blocks of this length: sequential
# adds within a block, then the running sum of the earlier blocks' totals
# added to each element
CUMSUM_BLOCK = 16

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


def mlp_init(gen, cfg: ModelConfig, *, device,
             d_ff: int | None = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
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
def dense(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
          train: bool = False, w: str = "w",
          b: str | None = "b") -> torch.Tensor:
    """y = x @ W (+bias) — on the simulated PICO-RAM macro when
    cfg.cim.enabled. CIM runs in f32 (integer-code arithmetic) and casts
    back to the compute dtype; the float path runs in the compute dtype.
    Under `train` the float weights run `cim_matmul_ste` (the analog
    forward, the float matmul's gradient); stored codes run as at
    inference."""
    if cfg.cim.enabled and (w + "_q") in p:
        with quant.act_site(w):
            y = cim_matmul_prequant(x.float(), p[w + "_q"], p[w + "_scale"],
                                    cfg.cim)
        y = y.to(dtype_of(cfg))
    elif cfg.cim.enabled:
        fn = cim_matmul_ste if train else cim_matmul
        with quant.act_site(w):
            y = fn(x.float(), p[w].float(), cfg.cim)
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


def cumsum_f32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive f32 cumulative sum in XLA:CPU's order (the reference's
    jnp.cumsum): sequential f32 adds within blocks of 16, the block totals
    summed the same way and added to each block. torch.cumsum accumulates
    in double on the CPU, which rounds otherwise."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= CUMSUM_BLOCK:
        out = [x[..., 0]]
        for i in range(1, n):
            out.append(out[-1] + x[..., i])
        return torch.stack(out, -1).movedim(-1, dim)
    pad = (-n) % CUMSUM_BLOCK
    if pad:
        x = F.pad(x, (0, pad))
    blocks = x.reshape(*x.shape[:-1], -1, CUMSUM_BLOCK)
    inner = cumsum_f32(blocks, -1)
    totals = cumsum_f32(inner[..., -1], -1)
    before = F.pad(totals[..., :-1], (1, 0))
    out = (inner + before[..., None]).reshape(*x.shape[:-1], -1)
    return out[..., :n].movedim(-1, dim)


def remat(cfg: ModelConfig, fn, *args):
    """fn(*args), recomputed in the backward under cfg.remat while autograd
    records (one layer of a training forward). Both remat_policy values
    recompute the whole call: the policy is a memory choice, and the
    recomputed forward is the same bits, so losses and gradients do not
    depend on it."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x·sigmoid(x), as jax.nn.silu composes it (F.silu rounds otherwise)."""
    return x * torch.sigmoid(x)


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


@functools.lru_cache(maxsize=None)
def _const(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`: a weakly typed constant of the reference
    enters an op in the operand's dtype."""
    return float(torch.tensor(value, dtype=dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU, jax.nn.gelu's default (approximate=True), in its op
    order: x · 0.5·(1 + tanh(√(2/π)·(x + 0.044715·x³))). F.gelu's default
    is the exact erf form, up to 4.7e-4 away."""
    c = _const(math.sqrt(2 / math.pi), x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + _const(0.044715, x.dtype)
                                       * (x * (x * x)))))
    return x * cdf


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              train: bool = False) -> torch.Tensor:
    up = dense(p, x, cfg, train=train, w="w_up", b=None)
    if cfg.mlp == "swiglu":
        gate = dense(p, x, cfg, train=train, w="w_gate", b=None)
        h = F.silu(gate) * up
    else:
        h = gelu(up)
    return dense(p, h, cfg, train=train, w="w_down", b=None)


class _RowGather(torch.autograd.Function):
    """table[idx] whose backward adds each row's cotangents in ascending
    token order with no atomics: the indices are sorted (stable), and the
    k-th occurrence of every distinct index is added in the k-th pass, so
    the gradient is the same bits on every run (advanced indexing's
    backward, index_put_ with accumulate, adds with atomics on CUDA)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        g2 = g.reshape(flat.numel(), -1)
        order = torch.argsort(flat, stable=True)
        uniq, counts = torch.unique_consecutive(flat[order],
                                                return_counts=True)
        starts = torch.cumsum(counts, 0) - counts
        acc = g2[order[starts]]
        for j in range(1, int(counts.max())):
            more = counts > j
            acc[more] = acc[more] + g2[order[starts[more] + j]]
        out = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        out[uniq] = acc
        return out, None


def embed_lookup(p: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Embedding rows of `tokens`; under autograd with a deterministic
    backward (`_RowGather`)."""
    table = p["embed"]
    if torch.is_grad_enabled() and table.requires_grad:
        return _RowGather.apply(table, tokens)
    return table[tokens]


def unembed(p: Params, h: torch.Tensor, cfg: ModelConfig, *,
            train: bool = False) -> torch.Tensor:
    if cfg.cim.enabled and "head_q" in p:
        with quant.act_site("head"):
            logits = cim_matmul_prequant(h.float(), p["head_q"],
                                         p["head_scale"], cfg.cim)
    else:
        w = p["embed"].T if cfg.tie_embeddings else p["head"]
        if cfg.cim.enabled:
            fn = cim_matmul_ste if train else cim_matmul
            with quant.act_site("head"):
                logits = fn(h.float(), w.float(), cfg.cim)
        else:
            logits = h @ w
    return logits.float()


class _PickLabel(torch.autograd.Function):
    """logits.gather(-1, labels) whose backward writes each row's one
    cotangent with scatter_ (no scatter_add: every row has one index, so
    no two writes meet and no atomics are needed)."""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(labels)
        ctx.shape, ctx.dtype = logits.shape, logits.dtype
        return logits.gather(-1, labels)

    @staticmethod
    def backward(ctx, g):
        (labels,) = ctx.saved_tensors
        out = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        return out.scatter_(-1, labels, g), None


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood logsumexp − picked: logits [.., V],
    labels [..] → [..], the reference's jax.nn.logsumexp (max-shifted)
    less take_along_axis."""
    picked = _PickLabel.apply(logits, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean CE. logits [.., V] f32, labels [..] int; with `mask`,
    Σ nll·mask / max(Σ mask, 1)."""
    per = nll(logits, labels)
    if mask is not None:
        return torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(per)


# ---------------------------------------------------------------------------
# chunked (flash-style) attention: the slot engine's prefill and `forward`
# ---------------------------------------------------------------------------
def _attn_block(q, k, v, mask, scale):
    """One (q-chunk × kv-chunk) block. q [B,Cq,KH,G,dh], k/v [B,Ckv,KH,dh];
    scores and the PV sum in f32 (the reference's preferred_element_type)."""
    s = torch.einsum("bqkgd,bckd->bqkgc", q.float(), k.float()) * scale
    s = torch.where(mask[:, :, None, None, :], s, -1e30)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bqkgc,bckd->bqkgd", p.to(v.dtype).float(), v.float())
    return m, l, o


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk: int,
                      q_offset: torch.Tensor | int = 0,
                      kv_valid: torch.Tensor | int | None = None,
                      triangular_max: int = 8) -> torch.Tensor:
    """Online-softmax attention: q [B,Tq,H,dh] × k,v [B,Tk,KH,dh] →
    [B,Tq,H,dh], GQA folded as H = KH × G.

    The reference's loops op by op: kv chunks combined from a −inf start
    with exp(m_acc − m_new); a triangular unroll (q chunk i visits only kv
    chunks below (i + 1)·cq) when causal, with at most `triangular_max` q
    chunks, an int q_offset of 0 and cq a multiple of ckv; else every q
    chunk over every kv chunk. Keys at or past `kv_valid` (or past the
    query's own position when causal) score −1e30.
    """
    b, tq, h, dh = q.shape
    tk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(dh)
    ckv = min(chunk, tk)
    cq = min(chunk, tq)
    pad_kv = (-tk) % ckv
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    pad_q = (-tq) % cq
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    nkv = (tk + pad_kv) // ckv
    nq = (tq + pad_q) // cq
    dev = q.device
    kv_valid = tk if kv_valid is None else kv_valid
    qs = q.reshape(b, nq, cq, kh, g, dh)
    ks = k.reshape(b, nkv, ckv, kh, dh)
    vs = v.reshape(b, nkv, ckv, kh, dh)
    q_idx_base = q_offset + torch.arange(cq, device=dev)

    def kv_scan(qi_abs, q_blk, j_hi):
        """Online softmax over kv chunks j in [0, j_hi)."""
        m_acc = torch.full((b, cq, kh, g), -math.inf, device=dev)
        l_acc = torch.zeros((b, cq, kh, g), device=dev)
        o_acc = torch.zeros((b, cq, kh, g, dh), device=dev)
        lim = torch.clamp(qi_abs[:, None] + 1, max=kv_valid) if causal \
            else kv_valid
        for j in range(j_hi):
            kj = j * ckv + torch.arange(ckv, device=dev)
            mask = (kj[None, :] < lim).expand(b, cq, ckv)
            m, l, o = _attn_block(q_blk, ks[:, j], vs[:, j], mask, scale)
            m_new = torch.maximum(m_acc, m)
            a_old = torch.exp(m_acc - m_new)
            a_new = torch.exp(m - m_new)
            l_acc = l_acc * a_old + l * a_new
            o_acc = o_acc * a_old[..., None] + o * a_new[..., None]
            m_acc = m_new
        return o_acc / torch.clamp(l_acc, min=1e-30)[..., None]

    triangular = causal and nq <= triangular_max \
        and isinstance(q_offset, int) and q_offset == 0 and cq % ckv == 0
    outs = [kv_scan(i * cq + q_idx_base, qs[:, i],
                    (i + 1) * cq // ckv if triangular else nkv)
            for i in range(nq)]
    out = torch.stack(outs, 1).reshape(b, nq * cq, h, dh)[:, :tq]
    return out.to(q.dtype)


def k_cache_dtype(x: torch.Tensor, cache: dict) -> torch.Tensor:
    return x.to(cache["k"].dtype)


def pad_cache(kv: dict, max_len: int) -> dict:
    """[L, B, T, ...] → [L, B, max_len, ...] with zeros (unchanged when
    T >= max_len)."""
    def pad(a):
        pad_t = max_len - a.shape[2]
        if pad_t <= 0:
            return a
        return F.pad(a, (0, 0) * (a.ndim - 3) + (0, pad_t))

    return {k: pad(a) for k, a in kv.items()}


def attention_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, train: bool = False,
                    causal: bool = True,
                    kv_x: torch.Tensor | None = None,
                    cache: dict | None = None,
                    cache_index: torch.Tensor | int = 0):
    """Self- or cross-attention over the slot cache. Returns (y, cache
    entries | None).

    Three routes, as in the reference:
    - decode self-attention (T = 1, no `kv_x`, a cache {"k", "v": [B, S,
      KH, dh]}): the new token's K/V are written IN PLACE at row
      `cache_index`, clamped into [0, S − 1] as `dynamic_update_slice`
      clamps its start, and the token attends over the first cache_index +
      1 rows (`decode_attention`);
    - decode cross-attention (`kv_x` given and a cache holding the
      encoder's K/V): only wq and wo run, the query attends over every
      cached row and the cache comes back unchanged;
    - otherwise the whole sequence attends through `chunked_attention`,
      K/V projected from `kv_x` when given (RoPE and the causal mask only
      for self-attention); with `cache={}` (prefill) the K/V come back as
      {"k", "v"}. This route is the training forward's (`train`: every
      projection through `dense(train=True)`).
    """
    b, t, _ = x.shape
    dh = cfg.head_dim
    rope_on = cfg.pos_embed == "rope" and kv_x is None
    q = dense(p, x, cfg, train=train, w="wq", b="bq").reshape(
        b, t, cfg.n_heads, dh)
    if rope_on:
        q = rope(q, positions, cfg.rope_theta, _rope_dims(cfg))
    new_cache = None
    if cache is not None and kv_x is None and t == 1:
        k1 = dense(p, x, cfg, w="wk", b="bk").reshape(b, 1, cfg.n_kv_heads,
                                                      dh)
        v1 = dense(p, x, cfg, w="wv", b="bv").reshape(b, 1, cfg.n_kv_heads,
                                                      dh)
        if rope_on:
            k1 = rope(k1, positions, cfg.rope_theta, _rope_dims(cfg))
        row = torch.as_tensor(cache_index, device=x.device).clamp(
            0, cache["k"].shape[1] - 1).reshape(1).long()
        cache["k"].index_copy_(1, row, k_cache_dtype(k1, cache))
        cache["v"].index_copy_(1, row, k_cache_dtype(v1, cache))
        o = decode_attention(q, cache["k"], cache["v"], cache_index + 1)
        new_cache = cache
    elif cache is not None and kv_x is not None and "k" in cache:
        o = decode_attention(q, cache["k"], cache["v"], cache["k"].shape[1])
        new_cache = cache
    else:
        src = x if kv_x is None else kv_x
        ts = src.shape[1]
        k = dense(p, src, cfg, train=train, w="wk", b="bk").reshape(
            b, ts, cfg.n_kv_heads, dh)
        v = dense(p, src, cfg, train=train, w="wv", b="bv").reshape(
            b, ts, cfg.n_kv_heads, dh)
        if rope_on:
            k = rope(k, positions, cfg.rope_theta, _rope_dims(cfg))
        o = chunked_attention(q, k, v, causal=causal and kv_x is None,
                              chunk=cfg.attn_chunk,
                              triangular_max=cfg.attn_triangular_max)
        if cache is not None:      # prefill: hand back the K/V
            new_cache = {"k": k, "v": v}
    y = dense(p, o.reshape(b, t, cfg.n_heads * dh), cfg, train=train,
              w="wo", b="bo")
    return y, new_cache


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
