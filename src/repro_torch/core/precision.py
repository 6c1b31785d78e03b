"""Precision extension: higher-precision MVM on the 4-bit macro (paper §V:
"the macro completes 4-bit analog MVM in a single clock cycle, yet can
support higher precision by leveraging the peripheral digital serial
processing [26], [28]"), and the ADC-resolution axis of the per-site
precision search.

An 8-bit × 8-bit MVM decomposes into nibbles:
    X = 16·X_hi + X_lo,  W̃ = 16·W̃_hi + W̃_lo   (all nibbles ∈ [0,15])
    Σ X W̃ = Σ_{i,j} 16^{i+j} · Q( X_i · W̃_j )
i.e. four bit-parallel analog passes + digital shift-and-add. Signed 8-bit
weights use the Eq. 7 offset with o = 128.
"""
from __future__ import annotations

import math

import torch

from .macro import MacroConfig
from .quant import _f32
from .schemes import bp_mvm, fold_generator, signed_correction


def adc_levels_for_bits(bits: float) -> int:
    """ADC quantization levels for a (possibly fractional) bit count: the
    paper's 8.5-bit TD-ADC has 362 levels (2^8.5 ≈ 362.04)."""
    return max(2, int(round(2.0 ** bits)))


def adc_bits_for_levels(levels: int) -> float:
    """Inverse of adc_levels_for_bits (exact log2)."""
    return math.log2(levels)


# Candidate ADC resolutions for the per-site precision search: the native
# 8.5-bit converter and progressively coarser settings down to 5 bits.
ADC_BIT_CANDIDATES = (8.5, 8.0, 7.5, 7.0, 6.5, 6.0, 5.5, 5.0)


def split_nibbles(codes: torch.Tensor):
    """8-bit unsigned codes → (hi, lo) 4-bit nibbles, in codes' dtype."""
    ci = codes.to(torch.int32)
    return (ci >> 4).to(codes.dtype), (ci & 15).to(codes.dtype)


def extended_mvm_codes(x_codes8: torch.Tensor, w_codes8: torch.Tensor,
                       cfg: MacroConfig, *,
                       key: torch.Generator | None = None) -> torch.Tensor:
    """ŷ ≈ Σ X̃·W̃ for 8-bit unsigned codes via 4 nibble passes on the
    4-bit macro. x [..., K], w [K, M]. Pass (i, j) draws its noise from
    schemes.fold_generator(key, 2i + j), where the reference calls
    fold_in(key, 2i + j)."""
    xh, xl = split_nibbles(x_codes8)
    wh, wl = split_nibbles(w_codes8)
    out = 0.0
    for i, xi in ((1, xh), (0, xl)):
        for j, wj in ((1, wh), (0, wl)):
            out = out + (16.0 ** (i + j)) * bp_mvm(
                xi, wj, cfg, key=fold_generator(key, i * 2 + j))
    return out


def extended_matmul(x: torch.Tensor, w: torch.Tensor, cfg: MacroConfig, *,
                    key: torch.Generator | None = None) -> torch.Tensor:
    """Float 8b×8b CIM matmul: affine 8-bit activations (zero point folded
    into the digital correction), symmetric signed 8-bit weights."""
    xs = x.detach()
    span = torch.clamp(xs.max() - torch.clamp(xs.min(), max=0.0), min=1e-8)
    s_x = span / _f32(255.0, span)
    zp = torch.round(torch.clamp(-xs.min() / s_x, 0, 255))
    x_codes = torch.clamp(torch.round(x / s_x) + zp, 0, 255)

    amax = torch.clamp(w.abs().max(), min=1e-8)
    s_w = amax / _f32(127.0, amax)
    w_codes = torch.clamp(torch.round(w / s_w), -128, 127) + 128.0

    y = extended_mvm_codes(x_codes, w_codes, cfg, key=key)
    y = signed_correction(y, x_codes, w_codes, w_offset=128, x_zero_point=zp)
    return y * s_x * s_w
