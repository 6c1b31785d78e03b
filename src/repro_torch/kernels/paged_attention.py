"""Paged-attention subsystem: block-table flash attention + registry.

A small registry of attention backends, each consuming the paged K/V pool
and the per-slot block tables directly:

  backend   what it does                                          runs on
  --------  ----------------------------------------------------  --------
  "exact"   gather each slot's window through its table, one-pass  any
            softmax over the whole window (models.common
            decode_attention / paged_prefill_attention)
  "kernel"  the Hopper flash kernel B3 (csrc/paged_attention.cu)    CUDA;
            over the tables; at decode (C = 1) one launch that      plain
            also does B4's K/V write; on a CPU tensor the plain     on CPU
            versions run
  "plain"   the plain PyTorch versions of B3 and B4, on any device  any
            (the card-side yardstick the kernels are held against)
  "auto"    "kernel"

B3 folds GQA as C·G rows per KV head, so decode (C = 1) and chunked
prefill are one kernel; the mask is pos_s <= lens + row // G and
pos_s < kv_len; masked scores are −1e30 and their weights forced to 0; V
rows at or past kv_len are zeroed with `where` before the PV product (the
trash block may hold NaN); the output is acc / max(l, 1e−30), so idle lanes
(kv_len = 0) emit 0.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.runtime.telemetry import KERNEL_COUNTERS

from . import autotune, build


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttnBackendSpec:
    """One paged-attention evaluation strategy.

    fn(q, k_pool, v_pool, tables, positions, kv_len, lens, splits) -> o
      q [B, C, H, dh]; pools [NB, bs, KH, dh]; tables [B, MB] physical
      block ids; positions [B, C] absolute query positions; kv_len [B]
      tokens valid INCLUDING this step's writes; lens [B] the chunk base
      positions[:, 0]; splits B3's S (`resolve_splits`). Returns [B, C,
      H, dh] in q's dtype.
    `decode_write_attend`, when set, is the decode step (C = 1) in one
    call: write each slot's new K/V row into the pools in place (flat
    target 0: no write), then attend.
      decode_write_attend(q, k_pool, v_pool, new_k, new_v, flat_idx,
                          tables, lens, kv_len, splits) -> o
    It replaces `models.common.paged_write` + `fn` on this backend.
    """

    name: str
    fn: Callable
    decode_write_attend: Callable | None = None


_ATTN_REGISTRY: dict[str, AttnBackendSpec] = {}


def register_attn_backend(name: str, *, decode_write_attend=None):
    """Register a paged-attention backend under `name` (decorator)."""
    def deco(fn):
        _ATTN_REGISTRY[name] = AttnBackendSpec(name, fn, decode_write_attend)
        return fn
    return deco


def get_attn_backend(name: str) -> AttnBackendSpec:
    try:
        return _ATTN_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown attention backend {name!r}; "
                         f"registered: {sorted(_ATTN_REGISTRY)}") from None


def available_attn_backends() -> tuple[str, ...]:
    return tuple(sorted(_ATTN_REGISTRY))


def choose_attn_backend(backend: str) -> str:
    """Resolve "auto" (or an explicit name) to a registered backend."""
    if backend != "auto":
        return get_attn_backend(backend).name
    return "kernel"


# ---------------------------------------------------------------------------
# "exact" backend: window gather + one-pass softmax
# ---------------------------------------------------------------------------
@register_attn_backend("exact")
def _exact_attention(q, k_pool, v_pool, tables, positions, kv_len, lens,
                     splits=None):
    """Window gather through the table + the dense-cache attention math,
    with V rows at positions >= kv_len zeroed (by `where`: 0 · NaN is NaN)
    before the PV contraction (one pass: `splits` has no meaning here)."""
    from repro_torch.models import common  # kernels must not import models
    k_win = common.paged_gather(k_pool, tables)
    v_win = common.paged_gather(v_pool, tables)
    w = k_win.shape[1]
    valid = torch.arange(w, device=q.device)[None, :] < kv_len[:, None]
    v_win = torch.where(valid[..., None, None], v_win,
                        torch.zeros((), dtype=v_win.dtype, device=q.device))
    if q.shape[1] == 1:
        return common.decode_attention(q, k_win, v_win,
                                       kv_len[:, None, None, None])
    return common.paged_prefill_attention(q, k_win, v_win, positions, kv_len)


# ---------------------------------------------------------------------------
# B3: flash attention over block tables
# ---------------------------------------------------------------------------
def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (32 lanes) in the order of a warp's xor
    butterfly: offsets 16, 8, 4, 2, 1."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def attn_splits(mb: int, splits: int | None = None) -> tuple[int, int]:
    """(S, per): B3 splits a slot's MB table columns over S ranks of a
    thread-block cluster, S = `splits` (the tuning cache's, see
    `resolve_splits`) or by default min(8, MB), rank r taking the
    contiguous columns [r·per, min((r+1)·per, MB)), per = ceil(MB / S). S
    depends on the table width only, never on the device-side kv_len."""
    s = max(1, min(8, mb)) if splits is None else splits
    return s, -(-mb // s)


def resolve_splits(tables: torch.Tensor, c: int, bs: int) -> int:
    """B3's S for this call: the tuning cache's `splits` under
    "paged_attn", the shape family of the window (MB·bs tokens) and C,
    backend "kernel" and the tables' platform; a miss keeps min(8, MB).
    Clamped to 1..min(8, MB), each clamp counted. The dispatchers above
    the kernel and the plain backend both call it, so the two combine the
    ranks' states in the same order."""
    mb = tables.shape[1]
    top = max(1, min(8, mb))
    if not autotune.cache_path():
        return top
    want = autotune.tuned("paged_attn", autotune.attn_family(mb * bs, c),
                          "kernel", tables.device).get("splits") or top
    s = min(max(int(want), 1), top)
    if s != int(want):
        KERNEL_COUNTERS.tune_clamp("paged_attn")
    return s


def paged_attn_plain(q, k_pool, v_pool, tables, lens, kv_len, splits=None):
    """Plain version of B3, in the kernel's exact operation order.

    The table columns split over S ranks (`attn_splits(MB, splits)`); each
    rank runs an online softmax over its own blocks in order, each block in
    pieces of at most 32 tokens (one piece when bs <= 32), one update per
    piece: each score is the lane-strided partial dot products
    (ceil(dh/32) per lane, in order; q and k padded with zeros to whole
    lanes) summed by the warp butterfly; the PV sum runs in token order. The ranks' states
    (m_r, l_r, acc_r) then combine in rank order: m* = max_r m_r,
    l* = Σ_r l_r·exp(m_r − m*) and acc* = Σ_r acc_r·exp(m_r − m*), each
    added in r order from 0, and out = acc* / max(l*, 1e−30). All math is
    f32 with separate multiplies and adds, so on the card it matches the
    kernel bit for bit. A rank's columns and pieces past kv_len (and the
    padding of the last rank) are exact no-ops: all weights 0, alpha 1.

    q [B, C, H, dh]; pools [NB, bs, KH, dh]; tables [B, MB]; lens [B] (the
    chunk's base position); kv_len [B]. Any dh and bs. Returns f32
    [B, C, H, dh].
    """
    b, c, h, dh = q.shape
    bs, kh = k_pool.shape[1], k_pool.shape[2]
    g = h // kh
    cg = c * g
    dpl = -(-dh // 32)
    dhp = 32 * dpl                   # the head dim padded to whole lanes
    dev = q.device
    mb = tables.shape[1]
    n_split, per = attn_splits(mb, splits)
    f32 = dict(dtype=torch.float32, device=dev)
    # [B, KH, 1 (rank), CG, 1 (token), dpl, 32]
    q3 = F.pad(q.float(), (0, dhp - dh)).reshape(b, c, kh, g, dhp) \
        .permute(0, 2, 1, 3, 4).reshape(b, kh, 1, cg, 1, dpl, 32)
    scale = 1.0 / math.sqrt(dh)      # multiplied as its f32 value
    m = torch.full((b, kh, n_split, cg), -1e30, **f32)
    l_sum = torch.zeros((b, kh, n_split, cg), **f32)
    acc = torch.zeros((b, kh, n_split, cg, dhp), **f32)
    pos_q = lens.long()[:, None] + (torch.arange(cg, device=dev) // g)
    kvl = kv_len.long()[:, None, None, None]                # [B,1,1,1]
    # pad the last rank's columns with the trash block: their positions lie
    # past the window, so they are masked like columns past kv_len
    tab = F.pad(tables.long(), (0, n_split * per - mb)).reshape(
        b, n_split, per)
    col0 = torch.arange(n_split, device=dev) * per          # [S]
    for jj in range(per):
        blk = tab[:, :, jj]                                 # [B, S]
        for t0 in range(0, bs, 32):                         # the pieces
            cnt = min(32, bs - t0)
            k = F.pad(k_pool[blk, t0:t0 + cnt].float(), (0, dhp - dh)) \
                .permute(0, 3, 1, 2, 4)                     # [B,KH,S,cnt,dhp]
            v = F.pad(v_pool[blk, t0:t0 + cnt].float(), (0, dhp - dh)) \
                .permute(0, 3, 1, 2, 4)
            pos_s = (col0 + jj)[:, None] * bs + t0 + torch.arange(
                cnt, device=dev)                            # [S, cnt]
            v = torch.where((pos_s[None, None, :, :, None] < kvl[..., None]),
                            v, 0.0)                         # select, never x0
            k6 = k.reshape(b, kh, n_split, 1, cnt, dpl, 32)
            part = q3[..., 0, :] * k6[..., 0, :]            # [B,KH,S,CG,cnt,32]
            for i in range(1, dpl):
                part = part + q3[..., i, :] * k6[..., i, :]
            s = _butterfly(part) * scale                    # [B,KH,S,CG,cnt]
            ok = ((pos_s[None, :, None, :] <= pos_q[:, None, :, None])
                  & (pos_s[None, :, None, :] < kvl))[:, None]
            s = torch.where(ok, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l_sum = l_sum * alpha + _butterfly(F.pad(p, (0, 32 - cnt)))
            pv = torch.zeros_like(acc)
            for t in range(cnt):
                pv = pv + p[..., t:t + 1] * v[:, :, :, None, t, :]
            acc = acc * alpha[..., None] + pv
            m = m_new
    # combine the ranks in rank order
    m_star = m.amax(dim=2)                                  # [B, KH, CG]
    l_star = torch.zeros_like(m_star)
    a_star = torch.zeros((b, kh, cg, dhp), **f32)
    for r in range(n_split):
        e = torch.exp(m[:, :, r] - m_star)
        l_star = l_star + l_sum[:, :, r] * e
        a_star = a_star + acc[:, :, r] * e[..., None]
    out = a_star[..., :dh] / torch.clamp(l_star, min=1e-30)[..., None]
    return out.reshape(b, kh, c, g, dh).permute(0, 2, 1, 3, 4) \
        .reshape(b, c, h, dh)


_DTYPES = (torch.bfloat16, torch.float32)


def _launch(q, k_pool, v_pool, tables, lens, kv_len, out_dtype, write,
            splits):
    """One launch of the B3 kernel on q's CUDA device; `write` is None (B3
    alone) or (new_k, new_v, flat), B4's decode write folded in; `splits`
    B3's S (None: min(8, MB)). Returns (the CUDA status, the output)."""
    b, c, h, dh = q.shape
    nb, bs, kh, dh_p = k_pool.shape
    if (v_pool.shape != k_pool.shape or v_pool.dtype != k_pool.dtype
            or dh_p != dh or h % kh):
        raise ValueError(f"shape mismatch q {tuple(q.shape)} pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if k_pool.dtype not in _DTYPES:
        raise ValueError(f"pool dtype {k_pool.dtype} unsupported")
    if q.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype} / out_dtype {out_dtype}: the "
                         "kernel reads and writes bfloat16 or float32")
    if not 1 <= dh <= 256:
        raise ValueError(f"head_dim {dh}: the kernel takes 1 <= dh <= 256")
    for t in (k_pool, v_pool, tables, lens, kv_len):
        if t.device != q.device:
            raise ValueError("all operands must lie on q's CUDA device")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned (copied in 16-byte "
                         "chunks)")
    nk = nv = flat = None
    if write is not None:
        new_k, new_v, flat_idx = write
        if c != 1:
            raise ValueError(f"the folded K/V write is a decode step (C = "
                             f"1), got C = {c}")
        if (new_k.shape != (b, 1, kh, dh) or new_v.shape != new_k.shape
                or flat_idx.numel() != b):
            raise ValueError(f"shape mismatch pools {tuple(k_pool.shape)} "
                             f"new {tuple(new_k.shape)} / "
                             f"{tuple(new_v.shape)} flat "
                             f"{tuple(flat_idx.shape)}")
        for t in (new_k, new_v):
            if t.dtype != k_pool.dtype or t.device != q.device:
                raise ValueError(f"new K/V rows must be {k_pool.dtype} on "
                                 "q's device")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError("new K/V rows must be contiguous and "
                                 "16-byte aligned (copied in 16-byte "
                                 "chunks)")
        if flat_idx.device != q.device:
            raise ValueError("all operands must lie on q's CUDA device")
        nk, nv = new_k.data_ptr(), new_v.data_ptr()
        flat = flat_idx.reshape(-1).to(torch.int32).contiguous()
    # each a no-op when the caller hands them over as contiguous int32
    q = q.contiguous()
    tables = tables.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    out = torch.empty(b, c, h, dh, dtype=out_dtype, device=q.device)
    mb = tables.shape[1]
    bf16 = torch.bfloat16
    rc = build.load("paged_attention").paged_attn_launch(
        int(k_pool.dtype == bf16), int(q.dtype == bf16),
        int(out_dtype == bf16), q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), nk, nv, None if flat is None else flat.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), b, c, h, kh, dh, bs, mb, *attn_splits(mb, splits),
        1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream)
    return rc, out


def paged_attn_call(q, k_pool, v_pool, tables, lens, kv_len, *,
                    out_dtype=torch.float32, splits=None):
    """B3 wrapper: q [B, C, H, dh] (bfloat16 or float32, read as it is) ×
    pools [NB, bs, KH, dh] through tables [B, MB] → [B, C, H, dh] in
    `out_dtype` (float32, or bfloat16 rounded once from the f32 result as
    `.to(torch.bfloat16)` rounds); `splits` is B3's S (`attn_splits`).
    Replaces `kernels/paged_attention.py:_paged_attn_call` of the JAX
    package."""
    if not q.is_cuda:
        return paged_attn_plain(q, k_pool, v_pool, tables, lens, kv_len,
                                splits).to(out_dtype)
    rc, out = _launch(q, k_pool, v_pool, tables, lens, kv_len, out_dtype,
                      None, splits)
    paged_attn_call.launches += 1
    if rc != 0:
        raise RuntimeError(f"paged_attn_call kernel launch failed: CUDA "
                           f"error {rc}")
    return out


# ---------------------------------------------------------------------------
# B4: the decode K/V write, in place, folded into B3's decode launch
# ---------------------------------------------------------------------------
def fused_write_plain(k_pool, v_pool, new_k, new_v, flat_idx):
    """Plain version of B4: each lane's K/V row goes to pool row flat_idx
    (block flat // bs, offset flat % bs), in place; flat_idx 0 writes
    nothing. Returns the (same) pools."""
    nb, bs = k_pool.shape[:2]
    fi = flat_idx.reshape(-1).long()
    keep = (fi != 0)[:, None, None]
    for pool, new in ((k_pool, new_k), (v_pool, new_v)):
        flat = pool.view(nb * bs, *pool.shape[2:])
        rows = new.reshape(-1, *new.shape[2:]).to(pool.dtype)
        # an invalid lane writes row 0 back onto itself: no change, and no
        # data-dependent shapes (so no host sync)
        rows = torch.where(keep, rows, flat[0])
        flat.index_put_((fi,), rows)
    return k_pool, v_pool


def decode_write_attend_plain(q, k_pool, v_pool, new_k, new_v, flat_idx,
                              tables, lens, kv_len, splits=None):
    """Plain version of the fused decode launch: B4's write, then B3.
    Returns f32 [B, 1, H, dh]."""
    fused_write_plain(k_pool, v_pool, new_k, new_v, flat_idx)
    return paged_attn_plain(q, k_pool, v_pool, tables, lens, kv_len, splits)


def decode_write_attend_call(q, k_pool, v_pool, new_k, new_v, flat_idx,
                             tables, lens, kv_len, *,
                             out_dtype=torch.float32, splits=None):
    """The decode step (C = 1) of one layer in one launch: B4 writes each
    slot's new row new_k / new_v [B, 1, KH, dh] (the pools' dtype) into
    pool row flat_idx [B] or [B, 1] IN PLACE (the TPU kernel aliased the
    pools to its outputs; 0 marks an invalid lane, which writes nothing,
    where `paged_write` would park it in the trash block), and B3 attends
    over the written pools, reading the new rows where they land. Same
    output as `paged_attn_call`. The scheduler copy-on-writes shared
    blocks before the step, so no other slot maps a write target.
    Replaces `kernels/paged_attention.py:_fused_write_call` then
    `_paged_attn_call` of the JAX package."""
    if not q.is_cuda:
        return decode_write_attend_plain(q, k_pool, v_pool, new_k, new_v,
                                         flat_idx, tables, lens, kv_len,
                                         splits).to(out_dtype)
    rc, out = _launch(q, k_pool, v_pool, tables, lens, kv_len, out_dtype,
                      (new_k, new_v, flat_idx), splits)
    decode_write_attend_call.launches += 1
    if rc != 0:
        raise RuntimeError(f"decode_write_attend_call kernel launch failed: "
                           f"CUDA error {rc}")
    return out


def _kernel_decode(q, k_pool, v_pool, new_k, new_v, flat_idx, tables, lens,
                   kv_len, splits=None):
    return decode_write_attend_call(q, k_pool, v_pool, new_k, new_v,
                                    flat_idx, tables, lens, kv_len,
                                    out_dtype=q.dtype, splits=splits)


def _plain_decode(q, k_pool, v_pool, new_k, new_v, flat_idx, tables, lens,
                  kv_len, splits=None):
    return decode_write_attend_plain(q, k_pool, v_pool, new_k, new_v,
                                     flat_idx, tables, lens, kv_len,
                                     splits).to(q.dtype)


@register_attn_backend("kernel", decode_write_attend=_kernel_decode)
def _kernel_attention(q, k_pool, v_pool, tables, positions, kv_len, lens,
                      splits=None):
    return paged_attn_call(q, k_pool, v_pool, tables, lens, kv_len,
                           out_dtype=q.dtype, splits=splits)


@register_attn_backend("plain", decode_write_attend=_plain_decode)
def _plain_attention(q, k_pool, v_pool, tables, positions, kv_len, lens,
                     splits=None):
    return paged_attn_plain(q, k_pool, v_pool, tables, lens, kv_len,
                            splits).to(q.dtype)


paged_attn_call.launches = 0
decode_write_attend_call.launches = 0


# ---------------------------------------------------------------------------
# dispatch (the single entry point models.common calls)
# ---------------------------------------------------------------------------
def paged_attention(q, k_pool, v_pool, tables, *, positions, kv_len,
                    lens=None, backend: str = "auto"):
    """Attend q [B, C, H, dh] over a paged KV pool through per-slot block
    tables; positions [B, C]; kv_len [B]; lens [B] the chunk base
    positions[:, 0], where the caller holds it (as int32 the kernel reads
    it without a copy). Returns [B, C, H, dh]. B3's S comes from the tuning
    cache (`resolve_splits`) for the kernel and the plain backend alike.
    Counts one call under the backend's name
    (`KERNEL_COUNTERS.attn_dispatch`; the one-launch decode of
    `models.common.paged_attention_apply` counts its own)."""
    spec = get_attn_backend(choose_attn_backend(backend))
    KERNEL_COUNTERS.count_attn(spec.name)
    if lens is None:
        lens = positions[:, 0]
    splits = resolve_splits(tables, q.shape[1], k_pool.shape[1])
    return spec.fn(q, k_pool, v_pool, tables, positions, kv_len, lens, splits)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
build.declare("paged_attention", {
    "paged_attn_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
})
