"""Mixture-of-Experts FFN (qwen2-moe): routed experts at a static capacity
plus the gated shared expert, the reference's `models/moe.py` with its
expert-parallel mesh branches.

Under an active mesh (`parallel.sharding`) whose "model" axis divides the
padded experts, each rank runs its E_pad / ep experts (expert
parallelism), in the port's execution model: every tensor stays whole on
each rank, and each rank computes its block of the work on slices taken
with `sharding.shard` (the expert stacks narrowed on dim 0, every leaf of
the stored codes with them), inside `sharding.shard_context()` so the
engine launches the local expert-batched kernel as it is:
  * psum-EP (cfg.moe.ep_mode "psum"): tokens over the batch axes, capacity
    from the local token count; the outputs of the ranks' experts summed
    over "model" in rank order, then gathered over the batch axes;
  * a2a-EP ("a2a"): a static-capacity all-to-all dispatch and combine
    (`parallel.collectives.a2a_dispatch` / `a2a_combine`); prefill and
    train split the sequence over "model" (t % ep == 0), decode splits
    each data shard's tokens into ep masked chunks and gathers the
    outputs;
  * a "model" axis that does not divide the padded experts: every rank
    runs the whole expert set on its batch slice, and the raw router
    statistics are summed over the batch axes (an exact load-balance
    loss).
As the reference's, the numbers follow the mesh's layout: capacities from
the local token count, each expert's dynamic DAC grid over its own
buffer, the combine's order. The expert MVMs are not salted (the
reference runs them per shard, unsalted).

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
from repro_torch.parallel import collectives, sharding

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
    if out.device.type == "meta":     # no values: one draw of the stack
        step = shape[0]
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
    """Slot index of each (token, choice) within its expert's buffer. An
    id of e_pad (a masked row of the a2a decode path) takes no capacity;
    its own position is never read."""
    onehot = (ids_flat[:, None] == torch.arange(
        e_pad, device=ids_flat.device)[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    return torch.gather(pos, 1, ids_flat.clamp(max=e_pad - 1)[:, None])[:, 0]


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


def _e_local(wp: dict) -> int:
    """The expert count of an _expert_weights dict (a rank's, once
    narrowed)."""
    v = next(iter(wp.values()))
    return (v.data if isinstance(v, PackedCodes) else v).shape[0]


def _shard_experts(wp: dict, part: tuple, ep: bool = True) -> dict:
    """This rank's experts of an _expert_weights dict: with `ep` every leaf
    (the packed bytes and their [E, 1, 1] / [E, 1, M] scales, int8 codes
    with their scales, the float weights) narrowed on dim 0 over "model",
    else the whole set; a gradient comes back whole, summed over `part`.
    The reference gathers FSDP D-shards here (`_gather_expert`). In the
    port the weights arrive whole: the Server's are, and a Trainer's
    placed layer was gathered whole when it began (`sharding.gathered`),
    so EP narrows the whole stack. Its "expert" block could be read in
    place (gathering only D over "data"), but psum-EP's expert gradients
    are partial over the batch axes, and `_Shard`'s backward is what sums
    them in rank order before the gather's backward slices the block:
    gathering keeps that order, and the step bit-identical to the
    whole-state Trainer's."""
    sl = [(0, ("model",))] if ep else []
    if "pk" in wp:
        pk = wp["pk"]
        return {"pk": PackedCodes(sharding.shard(pk.data, sl, part), pk.k,
                                  sharding.shard(pk.scale, sl, part))}
    return {name: sharding.shard(v, sl, part) for name, v in wp.items()}


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


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """v as an f32 scalar tensor on like's device (divisions by a count
    round as jnp's f32 divisions do)."""
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def _load_balance(probs: torch.Tensor, ids_flat: torch.Tensor,
                  n_experts: int) -> torch.Tensor:
    """n_experts · Σ_e me_e·pe_e: me the mean over (token, choice) of
    one_hot(ids) over the real experts, pe the mean of probs over the
    tokens; each mean a sum divided by the count (jnp.mean)."""
    me = _onehot_sum(ids_flat, n_experts) / _f32(ids_flat.shape[0], probs)
    pe = torch.sum(probs, dim=0) / _f32(probs.shape[0], probs)
    return n_experts * torch.sum(me * pe)


def _onehot_sum(ids_flat: torch.Tensor, n_experts: int,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Σ over (token, choice) of one_hot(ids) over the real experts (f32;
    an id past them, the masked rows' e_pad, is a zero row)."""
    onehot = (ids_flat[:, None] == torch.arange(
        n_experts, device=ids_flat.device)[None, :]).to(torch.float32)
    if mask is not None:
        onehot = onehot * mask.to(torch.float32)[:, None]
    return torch.sum(onehot, dim=0)


def _combine(out_flat: torch.Tensor, slot: torch.Tensor,
             weights: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """y2 [T, D]: each token's k choices out_flat[slot] · weight (the
    weight rounded to out's dtype) added in choice order from zero, as the
    reference's scatter-add."""
    y_choices = (_SlotGather.apply(out_flat, slot)
                 * weights.reshape(-1, 1).to(out_flat.dtype)).reshape(
                     t, k, -1)
    y2 = out_flat.new_zeros((t, out_flat.shape[-1]))
    for j in range(k):
        y2 = y2 + y_choices[:, j]
    return y2


def _local_moe(x2: torch.Tensor, router_w: torch.Tensor, wg: dict, wu: dict,
               wd: dict, cfg: ModelConfig, *, capacity: int,
               train: bool = False, e_offset: int = 0, stats: bool = False):
    """Dispatch x2's tokens [T, D] to the experts of wg / wu / wd (the
    contiguous slice [e_offset, e_offset + E_local) of the padded
    experts), compute and combine → (y2 [T, D] in the experts' output
    dtype, the load-balance loss). A choice keeps its slot only if its
    expert is local and within capacity; tokens routed elsewhere add zero
    (a sharded caller sums over the expert shards). With `stats` the
    second element is the unnormalised router sums (me_sum [E], pe_sum
    [E]) instead, for a caller that sums them over its shards."""
    t, d = x2.shape
    e_local = _e_local(wg)
    e_pad = padded_experts(cfg.moe.n_experts)
    k = cfg.moe.top_k
    probs, ids, weights = _route(x2, router_w, k)
    ids_flat = ids.reshape(-1)                                  # [T·k]
    pos = _positions_in_expert(ids_flat, e_pad)
    keep = pos < capacity
    if e_local != e_pad:
        keep = keep & (ids_flat >= e_offset) & (ids_flat < e_offset + e_local)
    slot = torch.where(keep, (ids_flat - e_offset) * capacity + pos,
                       e_local * capacity)                      # overflow row
    buf = x2.new_zeros((e_local * capacity + 1, d)).index_put(
        (slot,), _RepeatRows.apply(x2, k))
    out = _expert_ffn(buf[:-1].reshape(e_local, capacity, d), wg, wu, wd,
                      cfg, train)
    out_flat = torch.cat([out.reshape(e_local * capacity, d),
                          out.new_zeros((1, d))])
    y2 = _combine(out_flat, slot, weights, t, k)
    if stats:
        return y2, (_onehot_sum(ids_flat, cfg.moe.n_experts),
                    torch.sum(probs, dim=0))
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
    scalar tensor). Under an active mesh, the reference's mesh branches
    (module docstring); y and the loss come back whole on every rank."""
    b, t, d = x.shape
    y_shared = _shared_expert(p, x, cfg, train) if cfg.moe.n_shared else 0.0
    wg, wu, wd = (_expert_weights(p, name, cfg)
                  for name in ("e_gate", "e_up", "e_down"))
    axes = sharding.mesh_axes(sharding.get_mesh()) \
        if sharding.get_mesh() is not None else {}
    batch_axes = sharding.resolve("batch") or ()
    n_b = math.prod(axes[a] for a in batch_axes)
    if "model" not in axes \
            or padded_experts(cfg.moe.n_experts) % axes["model"]:
        if not axes or sharding.in_shard_context() or n_b <= 1 or b % n_b:
            # local: no mesh, already per shard, or no batch split
            y2, aux = _local_moe(x.reshape(b * t, d), p["router"], wg, wu,
                                 wd, cfg, capacity=_capacity(b * t, cfg),
                                 train=train)
            return y_shared + y2.reshape(b, t, d).to(x.dtype), aux
        y2, aux = _fallback_moe(p, x, wg, wu, wd, cfg, batch_axes, n_b, train)
        return y_shared + y2.to(x.dtype), aux
    if b % n_b:
        raise ValueError(f"batch {b} does not divide over the batch axes "
                         f"{batch_axes} ({n_b} ranks)")
    # expert parallel: the computation is partitioned over the batch axes
    # and "model"; every leaf a rank reads sums its gradient over them
    part = tuple(a for a in axes if a in batch_axes or a == "model")
    x_l = sharding.shard(x, [(0, batch_axes)], part)
    router = sharding.shard(p["router"], [], part)
    wg, wu, wd = (_shard_experts(w, part) for w in (wg, wu, wd))
    if cfg.moe.ep_mode == "a2a":
        y2, aux = _a2a_moe(x_l, router, wg, wu, wd, cfg, axes, batch_axes,
                           train)
    else:
        bl = b // n_b
        with sharding.shard_context():
            y2, aux = _local_moe(
                x_l.reshape(bl * t, d), router, wg, wu, wd, cfg,
                capacity=_capacity(bl * t, cfg), train=train,
                e_offset=sharding.axis_index("model") * _e_local(wg))
        y2 = sharding.ordered_sum(y2, ("model",)).reshape(bl, t, d)
        # the loss is the same on every rank: its mean over every axis
        aux = sharding.mean_over(aux, tuple(axes))
    y2 = sharding.gather(y2, 0, batch_axes)
    return y_shared + y2.to(x.dtype), aux


def _fallback_moe(p, x, wg, wu, wd, cfg: ModelConfig, batch_axes, n_b: int,
                  train: bool):
    """A "model" axis that does not divide the padded experts: the whole
    expert set on each batch shard (the same on every "model" rank), the
    raw router sums added over the batch axes for an exact loss → (y2 [B,
    T, D], aux)."""
    b, t, d = x.shape
    bl, ntot = b // n_b, b * t
    x_l = sharding.shard(x, [(0, batch_axes)], batch_axes)
    router = sharding.shard(p["router"], [], batch_axes)
    wg, wu, wd = (_shard_experts(w, batch_axes, ep=False)
                  for w in (wg, wu, wd))
    with sharding.shard_context():
        y2, (me_sum, pe_sum) = _local_moe(
            x_l.reshape(bl * t, d), router, wg, wu, wd, cfg,
            capacity=_capacity(bl * t, cfg), train=train, stats=True)
    me_sum = sharding.ordered_sum(me_sum, batch_axes)
    pe_sum = sharding.ordered_sum(pe_sum, batch_axes)
    aux = cfg.moe.n_experts * torch.sum(
        me_sum / _f32(ntot * cfg.moe.top_k, me_sum)
        * (pe_sum / _f32(ntot, pe_sum)))
    return sharding.gather(y2.reshape(bl, t, d), 0, batch_axes), aux


def _a2a_core(x2: torch.Tensor, router_w, wg, wu, wd, cfg: ModelConfig, *,
              cap: int, train: bool, valid: torch.Tensor | None = None):
    """The a2a-EP dispatch core, per shard: route this rank's tokens x2
    [T_rank, D], pack them into the static-capacity slot layout [E_pad,
    cap, D], exchange over "model" (a2a_dispatch), run the local experts,
    and combine through a2a_combine. `valid` masks padding rows: they
    route to the e_pad sentinel before the capacity cumsum, so they take
    no slot, and add no output and no router statistics.

    Returns (y2 [T_rank, D], me_sum [E], pe_sum [E], n_valid), the router
    statistics unnormalised for the caller's sum over "model"."""
    tloc, dl = x2.shape
    e_pad = padded_experts(cfg.moe.n_experts)
    k = cfg.moe.top_k
    probs, ids, weights = _route(x2, router_w, k)
    ids_flat = ids.reshape(-1)
    valid_flat = None
    if valid is not None:
        valid_flat = valid.repeat_interleave(k)
        ids_flat = torch.where(valid_flat, ids_flat, e_pad)
        weights = weights * valid[:, None].to(weights.dtype)
    pos = _positions_in_expert(ids_flat, e_pad)
    keep = pos < cap
    if valid_flat is not None:
        keep = keep & valid_flat
    slot = torch.where(keep, ids_flat * cap + pos, e_pad * cap)
    send = x2.new_zeros((e_pad * cap + 1, dl)).index_put(
        (slot,), _RepeatRows.apply(x2, k))
    recv = collectives.a2a_dispatch(send[:-1].reshape(e_pad, cap, dl),
                                    "model")
    out = _expert_ffn(recv, wg, wu, wd, cfg, train)   # [E_local, ep·cap, D]
    back = collectives.a2a_combine(out, "model").reshape(e_pad * cap, dl)
    back = torch.cat([back, back.new_zeros((1, dl))])
    y2 = _combine(back, slot, weights, tloc, k)
    if valid is not None:
        pe_sum = torch.sum(probs * valid[:, None].to(torch.float32), dim=0)
        n_valid = torch.sum(valid.to(torch.float32))
    else:
        pe_sum = torch.sum(probs, dim=0)
        n_valid = _f32(tloc, probs)
    return (y2, _onehot_sum(ids_flat, cfg.moe.n_experts, valid_flat),
            pe_sum, n_valid)


def _a2a_aux(me_sum, pe_sum, n_valid, cfg: ModelConfig, axes: dict):
    """The exact load-balance loss over the "model" token split, averaged
    over the other mesh axes (GShard's estimator, as the reference's)."""
    me_sum = sharding.ordered_sum(me_sum, ("model",))
    pe_sum = sharding.ordered_sum(pe_sum, ("model",))
    n = sharding.ordered_sum(n_valid, ("model",))
    one = _f32(1.0, n)
    me = me_sum / torch.maximum(n * cfg.moe.top_k, one)
    pe = pe_sum / torch.maximum(n, one)
    aux = cfg.moe.n_experts * torch.sum(me * pe)
    return sharding.mean_over(aux, tuple(a for a in axes if a != "model"))


def _a2a_moe(x_l, router, wg, wu, wd, cfg: ModelConfig, axes: dict,
             batch_axes, train: bool):
    """All-to-all dispatch EP on this rank's batch shard x_l [b_local, T,
    D] (whole over "model") → (y2 [b_local, T, D], aux). The capacity is
    per source rank: `_capacity` of the rank's own token count (the
    reference's `_a2a_capacity`, the same formula).

    Prefill / train (T divisible by ep): each "model" rank takes its
    contiguous T / ep tokens and the outputs are gathered back over
    "model". Decode (T too short): each "model" rank takes an ep-th chunk
    of the shard's b_local · T tokens (zero-padded, masked) and one gather
    over "model", cut to b_local · T rows, reassembles the outputs."""
    bl, t, d = x_l.shape
    ep = axes["model"]
    with sharding.shard_context():
        if t % ep == 0:
            tl = t // ep
            x_m = x_l.narrow(1, sharding.axis_index("model") * tl, tl)
            y2, me_sum, pe_sum, n_valid = _a2a_core(
                x_m.reshape(bl * tl, d), router, wg, wu, wd, cfg,
                cap=_capacity(bl * tl, cfg), train=train)
            y2 = y2.reshape(bl, tl, d)
        else:
            tloc = bl * t
            chunk = -(-tloc // ep)
            rank = sharding.axis_index("model")
            x2p = F.pad(x_l.reshape(tloc, d), (0, 0, 0, ep * chunk - tloc))
            valid = rank * chunk + torch.arange(chunk, device=x_l.device) \
                < tloc
            y2, me_sum, pe_sum, n_valid = _a2a_core(
                x2p.narrow(0, rank * chunk, chunk), router, wg, wu, wd, cfg,
                cap=_capacity(chunk, cfg), train=train, valid=valid)
    if t % ep == 0:
        y2 = sharding.gather(y2, 1, ("model",))
    else:
        y2 = sharding.gather(y2, 0, ("model",), size=bl * t).reshape(bl, t, d)
    return y2, _a2a_aux(me_sum, pe_sum, n_valid, cfg, axes)
