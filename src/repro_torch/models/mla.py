"""DeepSeek-V3 Multi-head Latent Attention (MLA).

The padded forward, the training forward and the slot engine's prefill
rebuild per-head K/V from the compressed latent through w_uk / w_uv (both
on the macro under CIM) and run the chunked attention, V padded to the qk
head dim; under `train` the seven projections run `dense(train=True)`
(cim_matmul_ste under CIM). Decode, inference only, is
the reference's *absorbed* form: the cache holds only the latent (kv_lora
+ rope = 576 values per position at full width), the query goes through
the float w_uk, scores are taken against the latent and the context goes
back through the float w_uv before the CIM output projection.

Layouts follow the reference package (`models/mla.py`): w_uk [kv_lora,
H·dn], w_uv [kv_lora, H·dv], caches {"latent": [B, S, kv_lora + rope]}.
The absorbed decode reads the float w_uk / w_uv, which
`models.quantize.quantize_params` replaces with stored codes, so a
prequantized model cannot decode, as in the reference (ROADMAP Queue C).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig

from . import common
from .common import _normal, dense, dtype_of, norm_init, rope


def init(gen: torch.Generator, cfg: ModelConfig, *, device) -> dict:
    """Random MLA weights from `gen`, in the model dtype."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(dtype=dtype_of(cfg), device=device)
    p = {}
    p.update(common.dense_init(gen, d, m.q_lora_rank, name_w="w_dq", **kw))
    p["q_norm"] = norm_init(m.q_lora_rank, kind="rmsnorm", **kw)
    p.update(common.dense_init(gen, m.q_lora_rank, h * qk, name_w="w_uq",
                               **kw))
    p.update(common.dense_init(gen, d, m.kv_lora_rank, name_w="w_dkv", **kw))
    p["kv_norm"] = norm_init(m.kv_lora_rank, kind="rmsnorm", **kw)
    p.update(common.dense_init(gen, m.kv_lora_rank, h * m.qk_nope_head_dim,
                               name_w="w_uk", **kw))
    p.update(common.dense_init(gen, m.kv_lora_rank, h * m.v_head_dim,
                               name_w="w_uv", **kw))
    p.update(common.dense_init(gen, d, m.qk_rope_head_dim, name_w="w_kr",
                               **kw))
    p.update(common.dense_init(
        gen, h * m.v_head_dim, d,
        scale=1.0 / math.sqrt(h * m.v_head_dim * 2 * cfg.n_layers),
        name_w="wo", **kw))
    return p


def _rms(cfg: ModelConfig) -> ModelConfig:
    """The config the q / kv latents are normed under: RMSNorm whatever
    cfg.norm says, as the reference's cfg.replace(norm="rmsnorm")."""
    return cfg if cfg.norm == "rmsnorm" else cfg.replace(norm="rmsnorm")


def _project_q(p: dict, x: torch.Tensor, cfg: ModelConfig, positions,
               train: bool = False):
    """The q LoRA: (q_nope [B,T,H,dn], q_rope [B,T,H,dr], RoPE applied)."""
    m = cfg.mla
    b, t, _ = x.shape
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    cq = common.norm(p["q_norm"], dense(p, x, cfg, train=train, w="w_dq",
                                        b=None), _rms(cfg))
    q = dense(p, cq, cfg, train=train, w="w_uq", b=None).reshape(
        b, t, cfg.n_heads, qk)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta,
                        m.qk_rope_head_dim)


def _latent(p: dict, x: torch.Tensor, cfg: ModelConfig, positions,
            train: bool = False):
    """The compressed KV latent and the shared rope key: [B,T,kv_lora],
    [B,T,dr]."""
    m = cfg.mla
    ckv = common.norm(p["kv_norm"], dense(p, x, cfg, train=train, w="w_dkv",
                                          b=None), _rms(cfg))
    kr = dense(p, x, cfg, train=train, w="w_kr", b=None)
    kr = rope(kr[:, :, None, :], positions, cfg.rope_theta,
              m.qk_rope_head_dim)[:, :, 0, :]
    return ckv, kr


def _float_weight(p: dict, name: str) -> torch.Tensor:
    if name not in p:
        raise KeyError(
            f"{name}: the absorbed MLA decode multiplies by the float "
            f"{name}, which quantize_params replaced with stored codes "
            f"({name}_q); a prequantized MLA model cannot decode, as in the "
            "reference (ROADMAP Queue C)")
    return p[name].float()


def _absorbed_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, positions,
                     latent: torch.Tensor, cache_index):
    """One token per slot against the latent cache [B, S, lat], which takes
    the token's latent IN PLACE at row cache_index (clamped into [0, S − 1]
    as dynamic_update_slice clamps its start); keys at or before
    cache_index (unclamped) are attended."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    q_nope, q_rope = _project_q(p, x, cfg, positions)
    ckv, kr = _latent(p, x, cfg, positions)
    s = latent.shape[1]
    row = torch.as_tensor(cache_index, device=x.device).clamp(
        0, s - 1).reshape(1).long()
    latent.index_copy_(1, row, torch.cat([ckv, kr], -1).to(latent.dtype))
    w_uk = _float_weight(p, "w_uk").reshape(m.kv_lora_rank, h,
                                            m.qk_nope_head_dim)
    w_uv = _float_weight(p, "w_uv").reshape(m.kv_lora_rank, h, m.v_head_dim)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk)
    q_full = torch.cat([q_abs, q_rope[:, 0].float().expand(
        b, h, m.qk_rope_head_dim)], -1)                       # [B, H, lat]
    lat = latent.float()
    # a true f32 division by the qk head dim's root, as the reference's
    qk_root = torch.full((), math.sqrt(m.qk_nope_head_dim
                                       + m.qk_rope_head_dim),
                         dtype=torch.float32, device=x.device)
    scores = torch.einsum("bhr,bsr->bhs", q_full, lat) / qk_root
    mask = torch.arange(s, device=x.device)[None, None, :] \
        <= torch.as_tensor(cache_index, device=x.device)
    scores = torch.where(mask, scores, -1e30)
    # softmax as jax.nn.softmax computes it: exp(x − max) / sum
    un = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    attn = un / torch.sum(un, dim=-1, keepdim=True)
    ctx = torch.einsum("bhs,bsr->bhr", attn, lat[..., :m.kv_lora_rank])
    o = torch.einsum("bhr,rhv->bhv", ctx, w_uv)
    o = o.reshape(b, 1, h * m.v_head_dim).to(x.dtype)
    return dense(p, o, cfg, w="wo", b=None)


def apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
          positions: torch.Tensor, train: bool = False,
          cache: dict | None = None, cache_index: torch.Tensor | int = 0,
          return_cache: bool = False):
    """MLA attention → (y, cache entries | None).

    Decode (T = 1 with a cache {"latent": [B, S, lat]}, no return_cache):
    the absorbed form over the latent cache, written in place; the cache
    comes back. Otherwise K/V are rebuilt from the latent and the sequence
    attends through `chunked_attention`; with return_cache its
    {"latent": [B, T, lat]} entries come back. `train` (this route only)
    runs the seven projections through dense(train=True).
    """
    if cache is not None and x.shape[1] == 1 and not return_cache \
            and "latent" in cache:
        y = _absorbed_decode(p, x, cfg, positions, cache["latent"],
                             cache_index)
        return y, cache
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _project_q(p, x, cfg, positions, train)
    ckv, kr = _latent(p, x, cfg, positions, train)
    k_nope = dense(p, ckv, cfg, train=train, w="w_uk", b=None).reshape(
        b, t, h, m.qk_nope_head_dim)
    v = dense(p, ckv, cfg, train=train, w="w_uv", b=None).reshape(
        b, t, h, m.v_head_dim)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(
        b, t, h, m.qk_rope_head_dim)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    # V's head dim padded to the qk dim: one attention call serves both
    pad = k.shape[-1] - v.shape[-1]
    v_p = torch.nn.functional.pad(v, (0, pad)) if pad > 0 else v
    o = common.chunked_attention(q, k, v_p, causal=True, chunk=cfg.attn_chunk,
                                 triangular_max=cfg.attn_triangular_max)
    o = o[..., :m.v_head_dim].reshape(b, t, h * m.v_head_dim)
    y = dense(p, o, cfg, train=train, w="wo", b=None)
    entries = {"latent": torch.cat([ckv, kr], -1)} if return_cache else None
    return y, entries
