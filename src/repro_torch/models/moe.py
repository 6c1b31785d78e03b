"""Mixture-of-Experts FFN (qwen2-moe): routed experts at a static capacity
plus the gated shared expert. The local path of the reference's
`models/moe.py`: no mesh, so no expert parallelism and no all-to-all
dispatch (ROADMAP A11).

Routed expert weights are [E, D, F], E padded to a multiple of EP_PAD
(qwen2's 60 → 64). Pad experts have no router logit, so they receive no
token; their MVMs still run, on all-zero buffers, as in the reference.
Under CIM the experts may hold stored codes (models.quantize):
nibble-packed uint8 [E, ceil(K/2), M] or int8 [E, K, M], with scales
[E, 1, 1] or [E, 1, M]. Each projection runs all experts in one
expert-batched call: core.cim_matmul.cim_matmul_prequant for stored codes
(one launch of B1 / B6 for packed codes), core.cim_matmul.cim_matmul for
float weights quantized on the fly (one launch of B2 / B5), each expert
on its own activation grid and weight scale. While a calibration span
recorder is open the experts run one call each instead.

The numerics follow the reference op by op (ROADMAP Queue C):
  * routing: f32 logits from the f32 router; softmax as jax.nn.softmax
    computes it, exp(x − max) / sum; top-k by a stable descending sort,
    so ties go to the lower expert index as in lax.top_k; the top-k
    weights renormalized by max(sum, 1e-9);
  * capacity max(8, ceil8(ceil(T·k·cf / E_pad))) over T = B·S tokens;
    slots from an exclusive cumsum over the flattened (token, choice)
    order, batch-major; every lane (idle and padding lanes too) is routed
    and takes capacity; choices past capacity go to a discarded last row;
  * each expert's activations on its own dynamic DAC grid, zero rows of
    a partly filled buffer included (the reference's act_scale under
    vmap);
  * the combine in the model dtype: y_choice = out[slot] · weight, the
    weight rounded to the model dtype; a token's k choices added in
    choice order starting from zero (the reference's scatter-add; not
    index_add_, whose CUDA atomics add in a run-dependent order); then
    y_shared + y.

`apply` returns (y, aux), aux the Switch-style load-balance loss of the
reference, n_experts · Σ_e me_e·pe_e over the real experts (me the share
of (token, choice) pairs routed to e, pe the mean routing probability),
each mean a sum then a division by the count, as jnp.mean computes it.
Under `train` the routed experts' float weights run `cim_matmul_ste` (one
expert-batched B2 forward per projection, per-expert float products
backward) and the shared expert `mlp_apply(train=True)`. The dispatch and
the combine are deterministic under autograd: the k copies of a token are
an expand whose gradient adds the k choices in choice order, and the
gathers of the capacity buffers write their gradients without atomics
(each real slot holds one (token, choice); the overflow row is dropped).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.core.cim_matmul import (cim_matmul, cim_matmul_prequant,
                                         cim_matmul_ste)
from repro_torch.core.engine import PackedCodes

from .common import _normal, dtype_of, mlp_apply, mlp_init

EP_PAD = 16  # the expert count pads to a multiple of this


def padded_experts(n: int) -> int:
    return -(-n // EP_PAD) * EP_PAD


# f32 elements drawn at once while initialising an expert stack
_INIT_CHUNK_ELEMS = 1 << 28


def _expert_stack(gen, shape, scale, dtype, device) -> torch.Tensor:
    """Random [E, K, M] expert weights in `dtype`, drawn a few experts at
    a time, so no f32 copy of the whole stack is held (15 GB for one
    deepseek-v3 projection)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    step = max(1, _INIT_CHUNK_ELEMS // (shape[1] * shape[2]))
    for e0 in range(0, shape[0], step):
        e1 = min(shape[0], e0 + step)
        out[e0:e1] = (_normal(gen, (e1 - e0,) + tuple(shape[1:]), device)
                      * scale).to(dtype)
    return out


def init(gen: torch.Generator, cfg: ModelConfig, *, device) -> dict:
    """Random MoE FFN weights from `gen` (the router in f32, the experts
    and the shared expert in the model dtype)."""
    m = cfg.moe
    e_pad = padded_experts(m.n_experts)
    d, f = cfg.d_model, m.d_ff_expert
    dt = dtype_of(cfg)
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(f * 2 * cfg.n_layers)
    p = {"router": _normal(gen, (d, m.n_experts), device) * 0.02,
         "e_gate": _expert_stack(gen, (e_pad, d, f), scale_in, dt, device),
         "e_up": _expert_stack(gen, (e_pad, d, f), scale_in, dt, device),
         "e_down": _expert_stack(gen, (e_pad, f, d), scale_out, dt, device)}
    if m.n_shared:
        p["shared"] = mlp_init(gen, cfg, device=device, d_ff=m.d_ff_shared)
        if m.shared_gate:
            p["shared"]["w_sg"] = (_normal(gen, (d, 1), device)
                                   * 0.02).to(dt)
    return p


# ---------------------------------------------------------------------------
# routing + static-capacity dispatch
# ---------------------------------------------------------------------------
def _route(x2: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """x2 [T, D] → (probs [T, E], ids [T, k], weights [T, k])."""
    logits = x2.float() @ router_w.float()
    un = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    probs = un / torch.sum(un, dim=-1, keepdim=True)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :top_k], ids[:, :top_k]
    weights = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True),
                                    min=1e-9)
    return probs, ids, weights


def _positions_in_expert(ids_flat: torch.Tensor, e_pad: int) -> torch.Tensor:
    """Slot index of each (token, choice) within its expert's buffer."""
    onehot = (ids_flat[:, None] == torch.arange(
        e_pad, device=ids_flat.device)[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    return torch.gather(pos, 1, ids_flat[:, None])[:, 0]


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k * m.capacity_factor
                      / padded_experts(m.n_experts)))
    return max(8, -(-c // 8) * 8)


def _expert_weights(p: dict, name: str, cfg: ModelConfig) -> dict:
    """One routed-expert weight as a small dict: {"w": float [E, K, M]};
    after models.quantize.quantize_params {"q": int8 codes, "s": scales}
    or, nibble-packed, {"pk": PackedCodes} carrying the code bytes [E,
    ceil(K/2), M] and the scales. Stored codes are read only when
    cfg.cim.enabled, as common.dense reads them."""
    if cfg.cim.enabled and name + "_q" in p:
        q, s = p[name + "_q"], p[name + "_scale"]
        if q.dtype == torch.uint8:
            k = cfg.d_model if name in ("e_gate", "e_up") \
                else cfg.moe.d_ff_expert
            return {"pk": PackedCodes(q, k, s)}
        return {"q": q, "s": s}
    return {"w": p[name]}


def _expert_slice(wp: dict, e: int) -> dict:
    if "pk" in wp:
        pk = wp["pk"]
        return {"pk": PackedCodes(pk.data[e], pk.k, pk.scale[e])}
    return {name: v[e] for name, v in wp.items()}


def _cim_mvm(xb: torch.Tensor, wp: dict, cfg: ModelConfig,
             train: bool = False) -> torch.Tensor:
    """One _expert_weights dict on the macro, expert-batched ([E, C, K]) or
    for one expert ([C, K]). Float weights stay in the model dtype: the
    quantizer widens them a few experts at a time; under `train` they run
    the STE."""
    if "pk" in wp:
        return cim_matmul_prequant(xb.float(), wp["pk"], None, cfg.cim)
    if "q" in wp:
        return cim_matmul_prequant(xb.float(), wp["q"], wp["s"], cfg.cim)
    w = wp["w"]
    mm = cim_matmul_ste if train else cim_matmul
    return mm(xb.float(), w if w.ndim == 3 else w.float(), cfg.cim)


def _expert_ffn(buf: torch.Tensor, wg: dict, wu: dict, wd: dict,
                cfg: ModelConfig, train: bool = False) -> torch.Tensor:
    """Batched expert MLP: buf [E, C, D] → [E, C, D].

    Under CIM the three projections run under the e_gate / e_up / e_down
    sites, one expert-batched call each; while a calibration span recorder
    is open they run expert by expert instead, so each expert's span is
    recorded, as the reference unrolls its vmap then."""
    if cfg.cim.enabled:
        def f(xb, wp, site):
            with quant.act_site(site):
                if quant.recording_active():
                    return torch.stack([
                        _cim_mvm(xb[e], _expert_slice(wp, e), cfg, train)
                        for e in range(xb.shape[0])])
                return _cim_mvm(xb, wp, cfg, train)
        h = F.silu(f(buf, wg, "e_gate")) * f(buf, wu, "e_up")
        return f(h, wd, "e_down").to(buf.dtype)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg["w"])) \
        * torch.einsum("ecd,edf->ecf", buf, wu["w"])
    return torch.einsum("ecf,efd->ecd", h, wd["w"])


class _RepeatRows(torch.autograd.Function):
    """x2 [T, D] → each row k times, [T·k, D] (the reference's
    x2[repeat(arange(T), k)]); the backward adds a token's k cotangents in
    choice order from zero, as the combine adds its choices."""

    @staticmethod
    def forward(ctx, x2, k):
        ctx.k = k
        t, d = x2.shape
        return x2[:, None, :].expand(t, k, d).reshape(t * k, d)

    @staticmethod
    def backward(ctx, g):
        g3 = g.reshape(-1, ctx.k, g.shape[-1])
        acc = torch.zeros_like(g3[:, 0])
        for j in range(ctx.k):
            acc = acc + g3[:, j]
        return acc, None


class _SlotGather(torch.autograd.Function):
    """table[slot] for a capacity buffer whose rows other than the last
    (the overflow row) each appear at most once in `slot`: the backward
    writes each row's one cotangent (index_put_ without accumulation, no
    atomics) and zeroes the overflow row, where several meet."""

    @staticmethod
    def forward(ctx, table, slot):
        ctx.save_for_backward(slot)
        ctx.shape = table.shape
        return table[slot]

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        out = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        out.index_put_((slot,), g)
        out[-1] = 0
        return out, None


def _load_balance(probs: torch.Tensor, ids_flat: torch.Tensor,
                  n_experts: int) -> torch.Tensor:
    """n_experts · Σ_e me_e·pe_e: me the mean over (token, choice) of
    one_hot(ids) over the real experts, pe the mean of probs over the
    tokens; each mean a sum divided by the count (jnp.mean)."""
    onehot = (ids_flat[:, None] == torch.arange(
        n_experts, device=ids_flat.device)[None, :]).to(torch.float32)
    me = torch.sum(onehot, dim=0) / torch.full(
        (), float(ids_flat.shape[0]), device=probs.device)
    pe = torch.sum(probs, dim=0) / torch.full(
        (), float(probs.shape[0]), device=probs.device)
    return n_experts * torch.sum(me * pe)


def _local_moe(x2: torch.Tensor, router_w: torch.Tensor, wg: dict, wu: dict,
               wd: dict, cfg: ModelConfig, *, capacity: int,
               train: bool = False):
    """Dispatch x2's tokens [T, D] to every expert, compute and combine →
    (y2 [T, D] in the experts' output dtype, the load-balance loss)."""
    t, d = x2.shape
    e_pad = padded_experts(cfg.moe.n_experts)
    k = cfg.moe.top_k
    probs, ids, weights = _route(x2, router_w, k)
    ids_flat = ids.reshape(-1)                                  # [T·k]
    pos = _positions_in_expert(ids_flat, e_pad)
    slot = torch.where(pos < capacity, ids_flat * capacity + pos,
                       e_pad * capacity)                        # overflow row
    buf = x2.new_zeros((e_pad * capacity + 1, d)).index_put(
        (slot,), _RepeatRows.apply(x2, k))
    out = _expert_ffn(buf[:-1].reshape(e_pad, capacity, d), wg, wu, wd, cfg,
                      train)
    out_flat = torch.cat([out.reshape(e_pad * capacity, d),
                          out.new_zeros((1, d))])
    y_choices = (_SlotGather.apply(out_flat, slot)
                 * weights.reshape(-1, 1).to(out.dtype)).reshape(t, k, d)
    y2 = out.new_zeros((t, d))
    for j in range(k):                  # the scatter-add's order
        y2 = y2 + y_choices[:, j]
    return y2, _load_balance(probs, ids_flat, cfg.moe.n_experts)


def _shared_expert(p: dict, x: torch.Tensor, cfg: ModelConfig,
                   train: bool = False):
    y = mlp_apply(p["shared"], x, cfg, train=train)
    if cfg.moe.shared_gate:
        y = y * torch.sigmoid(x @ p["shared"]["w_sg"].to(x.dtype))
    return y


def apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
          train: bool = False):
    """MoE FFN: x [B, T, D] → (y [B, T, D], the load-balance loss, an f32
    scalar tensor)."""
    b, t, d = x.shape
    y_shared = _shared_expert(p, x, cfg, train) if cfg.moe.n_shared else 0.0
    wg, wu, wd = (_expert_weights(p, name, cfg)
                  for name in ("e_gate", "e_up", "e_down"))
    y2, aux = _local_moe(x.reshape(b * t, d), p["router"], wg, wu, wd, cfg,
                         capacity=_capacity(b * t, cfg), train=train)
    return y_shared + y2.reshape(b, t, d).to(x.dtype), aux
