"""Quantizers and straight-through estimators (STE) for CIM-aware
arithmetic.

The paper stores 4-bit weights (signed, offset-encoded per Eq. 7) and drives
4-bit DAC activations. This module holds the configs, the dynamic
activation range and the calibrated static grid, the affine activation
quantizer, the weight quantizer, the call-site scope and the span
recorder that calibration (analysis.calibrate) reads. Training uses the
standard STE (Eq. 5): `round_ste` / `clip_ste` pass the gradient straight
through, so `cim_matmul` stays differentiable end to end (the reference's
quantizers use them at the same places).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ActQuantConfig:
    """Activation (DAC input) quantizer — asymmetric affine to u4 codes.

    `static_scale` pins the calibrated fixed DAC grid (analysis.calibrate):
    act_scale returns it, and the zero point is `static_zero_point` (0
    keeps the unsigned grid; a calibrated zp > 0 covers a signed
    activation's negative tail), so each lane's grid is independent of
    what else shares the serving batch. None = the dynamic per-tensor
    range.
    """

    bits: int = 4
    clip_percentile: float = 1.0
    static_scale: float | None = None
    static_zero_point: float = 0.0

    @property
    def qmax(self) -> int:
        return (1 << self.bits) - 1


@dataclasses.dataclass(frozen=True)
class WeightQuantConfig:
    """Weight quantizer — symmetric signed 4-bit, offset-encoded (Eq. 7)."""

    bits: int = 4
    per_channel: bool = False  # per-output-channel scales (beyond-paper knob)

    @property
    def qmax(self) -> int:  # +7 for 4-bit
        return (1 << (self.bits - 1)) - 1

    @property
    def qmin(self) -> int:  # -8 for 4-bit
        return -(1 << (self.bits - 1))

    @property
    def offset(self) -> int:  # Eq. 7: W̃ = W + 8 ∈ [0, 15]
        return 1 << (self.bits - 1)


class SpanRecord(float):
    """One recorded activation-range observation: a float (the span,
    max − min(·, 0)) carrying the call-site name (`site`, the weight name
    of the enclosing matmul, without a layer index), the signed range
    [lo, hi], the reduction depth `k`, the row count `rows` and, once
    cim_matmul has seen the weight, its output columns `m` (None before
    that, or when act_scale ran outside a matmul)."""

    site: str | None
    lo: float
    hi: float
    k: int
    rows: int
    m: int | None

    def __new__(cls, span: float, *, site=None, lo=0.0, hi=0.0, k=0,
                rows=0, m=None):
        self = super().__new__(cls, span)
        self.site = site
        self.lo = lo
        self.hi = hi
        self.k = k
        self.rows = rows
        self.m = m
        return self


# Call-site identity: models wrap each CIM-routed matmul in an `act_site`
# scope named after the weight ("wq", "w_up", "head", ...). Per-site
# precision overrides (cim_matmul.resolve_site_cfg) and the span recorder
# read it.
_SITE_STACK: list[str] = []


@contextlib.contextmanager
def act_site(name: str):
    """Name the enclosing CIM call site (layer-index-free weight name)."""
    _SITE_STACK.append(name)
    try:
        yield
    finally:
        _SITE_STACK.pop()


def current_site() -> str | None:
    return _SITE_STACK[-1] if _SITE_STACK else None


# Calibration hook: while a `record_act_spans()` context is open, act_scale
# appends every activation span it computes, in call order, as a
# SpanRecord. Reading a span back is a host sync, so it happens only while
# a recorder is open; the serving path never opens one.
_SPAN_RECORDER: list[list] = []


def recording_active() -> bool:
    """True while any record_act_spans() context is open."""
    return bool(_SPAN_RECORDER)


@contextlib.contextmanager
def record_act_spans():
    """Collect per-matmul activation spans (max − min(·, 0)) during
    forwards; yields the list being filled (SpanRecord entries)."""
    spans: list[SpanRecord] = []
    _SPAN_RECORDER.append(spans)
    try:
        yield spans
    finally:
        # detach by identity: nested recorders hold ==-equal lists
        _SPAN_RECORDER[:] = [r for r in _SPAN_RECORDER if r is not spans]


def _tracks_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """round() with a straight-through gradient (Eq. 5: d round(x)/dx := 1):
    x + (round(x) − x) with the bracket detached, the reference's form. Off
    the autograd graph it is torch.round itself (the same value: round(x) −
    x is exact in f32, and so is adding it back)."""
    if not _tracks_grad(x):
        return torch.round(x)
    return x + (torch.round(x) - x).detach()


def clip_ste(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """clip() whose gradient is 1 inside and outside the range (the pure
    STE of Eq. 5), as x + (clip(x) − x) with the bracket detached; off the
    autograd graph torch.clamp itself (the same value wherever |x| stays
    below 2²³, as the codes' do)."""
    if not _tracks_grad(x):
        return torch.clamp(x, lo, hi)
    return x + (torch.clamp(x, lo, hi) - x).detach()


def fake_quant_unsigned(x: torch.Tensor, bits: int,
                        scale: torch.Tensor) -> torch.Tensor:
    """Fake-quantize to unsigned `bits` levels with STE: x ≈ scale * q
    (the round and the clip pass the gradient straight through)."""
    qmax = (1 << bits) - 1
    if not torch.is_tensor(scale):
        scale = _f32(float(scale), x)
    q = clip_ste(round_ste(x / scale), 0.0, float(qmax))
    return q * scale


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """v as an f32 tensor on like's device: dividing by a tensor is a true
    division on every device (a Python divisor becomes a multiply by its
    reciprocal on CUDA)."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _expert_dims(x: torch.Tensor) -> tuple:
    """Every axis but the leading expert axis."""
    return tuple(range(1, x.ndim))


def act_scale(x: torch.Tensor, cfg: ActQuantConfig, *,
              per_expert: bool = False) -> torch.Tensor:
    """Activation scale: the static calibrated grid when cfg.static_scale
    is set (an f32 tensor, so quantize_act divides by it as the reference
    divides by its f32 constant), else the dynamic per-tensor affine range
    (max − min(·, 0)) / qmax over the WHOLE tensor: every lane of a
    batched serving step shares one grid.

    per_expert: x is [E, C, K] (the MoE routed experts) and each expert
    gets its own dynamic grid over its [C, K] slice, zero rows included,
    as the reference's act_scale under vmap: the scale is [E, 1, 1]. Its
    spans are not recorded (models.moe unrolls the experts while a
    recorder is open)."""
    if cfg.static_scale is not None:
        return _f32(float(cfg.static_scale), x)
    xs = x.detach()
    if per_expert:
        if _SPAN_RECORDER:
            raise RuntimeError("per-expert activation grids are not "
                               "recorded: unroll the experts while a span "
                               "recorder is open (models.moe)")
        dims = _expert_dims(xs)
        lo = torch.clamp(torch.amin(xs, dim=dims, keepdim=True), max=0.0)
        span = torch.clamp(torch.amax(xs, dim=dims, keepdim=True) - lo,
                           min=1e-8)
        return span / _f32(float(cfg.qmax), span)
    lo = torch.clamp(xs.min(), max=0.0)
    hi = xs.max()
    span = torch.clamp(hi - lo, min=1e-8)
    if _SPAN_RECORDER:
        rec_entry = SpanRecord(
            float(span), site=current_site(), lo=float(lo), hi=float(hi),
            k=int(x.shape[-1]) if x.ndim else 1,
            rows=int(x.numel() // x.shape[-1]) if x.ndim else 1)
        for rec in _SPAN_RECORDER:
            rec.append(rec_entry)
    return span / _f32(float(cfg.qmax), span)


def annotate_recorded_shape(m: int) -> None:
    """Attach the matmul's output-column count to the most recent span
    record (called by cim_matmul, which sees the weight)."""
    for rec in _SPAN_RECORDER:
        if rec and rec[-1].m is None:
            rec[-1].m = int(m)


def weight_scale(w: torch.Tensor, cfg: WeightQuantConfig, *,
                 per_expert: bool = False) -> torch.Tensor:
    """Symmetric weight scale; per-channel reduces over all but last dim.

    per_expert: w is [E, K, M] (the MoE routed experts) and each expert
    gets its own scale, [E, 1, 1] or per-channel [E, 1, M], as the
    reference's weight_scale under vmap. Its |w| max is max(max w, −min w)
    in w's own dtype (exact: no value is rounded), so no |w| copy of the
    expert stack is made, and it is then widened to f32."""
    if per_expert:
        dims = (1,) if cfg.per_channel else (1, 2)
        amax = torch.maximum(torch.amax(w, dim=dims, keepdim=True),
                             -torch.amin(w, dim=dims, keepdim=True)).float()
    elif cfg.per_channel:
        amax = torch.amax(w.abs(), dim=tuple(range(w.ndim - 1)), keepdim=True)
    else:
        amax = w.abs().max()
    amax = torch.clamp(amax, min=1e-8)
    return (amax / _f32(float(cfg.qmax), amax)).detach()


def quantize_act(x: torch.Tensor, scale: torch.Tensor, cfg: ActQuantConfig,
                 *, per_expert: bool = False):
    """x → (u4 DAC codes, zero_point): q = clip(round(x/s) + z, 0, 15).
    Dynamic: z = round(clip(−min(x)/s, 0, 15)), min per expert ([E, 1, 1])
    under `per_expert` (see act_scale). Static grid: z is the calibrated
    `static_zero_point`, rounded to f32 as the reference's
    jnp.asarray(float, f32) rounds it, on x's device. round is
    half-to-even, as in the reference; the round and the clip of the
    codes are the STE ones (d q / d x = 1 / s)."""
    qmax = float(cfg.qmax)
    if cfg.static_scale is not None:
        zp = _f32(float(cfg.static_zero_point), x)
    else:
        xs = x.detach()
        lo = torch.amin(xs, dim=_expert_dims(xs), keepdim=True) \
            if per_expert else xs.min()
        zp = torch.round(torch.clamp(-lo / scale, 0, qmax))
    q = clip_ste(round_ste(x / scale) + zp, 0.0, qmax)
    return q, zp


def quantize_weight(w: torch.Tensor, scale: torch.Tensor,
                    cfg: WeightQuantConfig) -> torch.Tensor:
    """w → unsigned stored codes W̃ ∈ [0, 2^b-1] per the paper's Eq. 7
    (STE round and clip, as the reference's)."""
    q_signed = clip_ste(round_ste(w / scale), float(cfg.qmin),
                        float(cfg.qmax))
    return q_signed + cfg.offset


# f32 elements of one expert chunk's temporaries in quantize_weight_experts
_EXPERT_CHUNK_ELEMS = 1 << 28


def quantize_weight_experts(w: torch.Tensor, scale: torch.Tensor,
                            cfg: WeightQuantConfig) -> torch.Tensor:
    """quantize_weight over an expert stack w [E, K, M] (any float dtype)
    with per-expert scales [E, 1, 1] or [E, 1, M] → f32 codes [E, K, M],
    made into one container a few experts at a time: elementwise, so the
    codes are quantize_weight's on w.float(), without that f32 copy and
    its temporaries of the whole stack (15 GB each for one deepseek-v3
    projection)."""
    e = w.shape[0]
    out = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    step = max(1, _EXPERT_CHUNK_ELEMS // max(1, w[0].numel()))
    for e0 in range(0, e, step):
        e1 = min(e, e0 + step)
        out[e0:e1] = quantize_weight(w[e0:e1].float(), scale[e0:e1], cfg)
    return out


def bit_planes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Unsigned integer codes → `bits` binary planes, shape (bits,) +
    q.shape, plane p holding bit p (LSB first), in q's dtype. The BS / WBS
    baselines (Eq. 2) run one analog pass per plane."""
    qi = q.to(torch.int32)
    return torch.stack([(qi >> p) & 1 for p in range(bits)],
                       dim=0).to(q.dtype)
