"""Quantizers for CIM-aware arithmetic (inference side).

The paper stores 4-bit weights (signed, offset-encoded per Eq. 7) and drives
4-bit DAC activations. This module holds the configs, the dynamic
activation range, the affine activation quantizer and the weight
quantizer. The straight-through estimators used for training are queued
with training (ROADMAP A10); the static calibrated grid with calibration
(ROADMAP A7).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ActQuantConfig:
    """Activation (DAC input) quantizer — asymmetric affine to u4 codes.

    `static_scale` / `static_zero_point` describe the calibrated fixed grid
    of the reference; setting `static_scale` raises here until calibration
    is ported (ROADMAP A7).
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


# Call-site identity: models wrap each CIM-routed matmul in an `act_site`
# scope named after the weight ("wq", "w_up", "head", ...). The port keeps
# the scope so per-site overrides can resolve against it once they land
# (ROADMAP A7).
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


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """v as an f32 tensor on like's device: dividing by a tensor is a true
    division on every device (a Python divisor becomes a multiply by its
    reciprocal on CUDA)."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def act_scale(x: torch.Tensor, cfg: ActQuantConfig) -> torch.Tensor:
    """Dynamic per-tensor affine range (max − min(·, 0)) / qmax, over the
    WHOLE tensor: every lane of a batched serving step shares one grid."""
    if cfg.static_scale is not None:
        raise NotImplementedError(
            "static calibrated activation grids are not ported yet "
            "(ROADMAP A7)")
    xs = x.detach()
    lo = torch.clamp(xs.min(), max=0.0)
    hi = xs.max()
    span = torch.clamp(hi - lo, min=1e-8)
    return span / _f32(float(cfg.qmax), span)


def weight_scale(w: torch.Tensor, cfg: WeightQuantConfig) -> torch.Tensor:
    """Symmetric weight scale; per-channel reduces over all but last dim."""
    if cfg.per_channel:
        amax = torch.amax(w.abs(), dim=tuple(range(w.ndim - 1)), keepdim=True)
    else:
        amax = w.abs().max()
    amax = torch.clamp(amax, min=1e-8)
    return (amax / _f32(float(cfg.qmax), amax)).detach()


def quantize_act(x: torch.Tensor, scale: torch.Tensor, cfg: ActQuantConfig):
    """x → (u4 DAC codes, zero_point): q = clip(round(x/s) + z, 0, 15) with
    z = round(clip(−min(x)/s, 0, 15)). round is half-to-even, as in the
    reference."""
    if cfg.static_scale is not None:
        raise NotImplementedError(
            "static calibrated activation grids are not ported yet "
            "(ROADMAP A7)")
    qmax = float(cfg.qmax)
    zp = torch.round(torch.clamp(-x.detach().min() / scale, 0, qmax))
    q = torch.clamp(torch.round(x / scale) + zp, 0.0, qmax)
    return q, zp


def quantize_weight(w: torch.Tensor, scale: torch.Tensor,
                    cfg: WeightQuantConfig) -> torch.Tensor:
    """w → unsigned stored codes W̃ ∈ [0, 2^b-1] per the paper's Eq. 7."""
    q_signed = torch.clamp(torch.round(w / scale), float(cfg.qmin),
                           float(cfg.qmax))
    return q_signed + cfg.offset
