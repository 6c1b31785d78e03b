"""Bit-parallel analog MVM flow and the Eq. 7 digital correction.

  BP (Eq. 1):  ŷ = Σ_g Q_g( Σ_{i∈g} W̃_i X̃_i )      one ADC per 144-row group

with Q the TD-ADC transfer at full scale (core.adc.adc_quantize, at every
sim level). The weight-bit-serial and bit-serial baselines are queued with
the paper figures (ROADMAP A8).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .adc import adc_quantize
from .macro import MacroConfig, Scheme


def pad_and_group(x: torch.Tensor, n_rows: int, axis: int = -1):
    """Zero-pad the reduction axis to a multiple of N and split into groups.

    Zero codes are exact no-ops in the analog array (an unselected row's
    C_MOM holds no DAC charge), so padding is free and bit-exact.
    """
    axis = axis % x.ndim
    k = x.shape[axis]
    groups = max(1, -(-k // n_rows))
    pad = groups * n_rows - k
    if pad:
        widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
        x = F.pad(x, widths)
    new_shape = x.shape[:axis] + (groups, n_rows) + x.shape[axis + 1:]
    return x.reshape(new_shape), groups


def bp_mvm(x_codes: torch.Tensor, w_codes: torch.Tensor, cfg: MacroConfig,
           *, key: torch.Generator | None = None,
           inl_seed: int = 0) -> torch.Tensor:
    """Bit-parallel MVM, written like the reference `schemes.bp_mvm`: one
    einsum over every group, then the ADC transfer (`adc_quantize`, which
    divides by the LSB and, at NOISY/FULL, adds the INL instance and noise
    drawn from the torch.Generator `key`), then the sum over groups. It
    divides where the kernels multiply by 1/LSB, so at IDEAL it agrees with
    them to within one LSB rounding tie, not bit for bit."""
    if cfg.scheme != Scheme.BP:
        raise NotImplementedError(f"scheme {cfg.scheme} is not ported yet "
                                  "(ROADMAP A8)")
    xg, _ = pad_and_group(x_codes.float(), cfg.n_rows)
    wg, _ = pad_and_group(w_codes.float(), cfg.n_rows, axis=0)
    v = torch.einsum("...gn,gnm->...gm", xg, wg)
    q = adc_quantize(v, cfg, key=key, act_bits_active=cfg.act_bits,
                     weight_bits_active=cfg.weight_bits, inl_seed=inl_seed)
    return torch.sum(q, dim=-2)


def cim_mvm_codes(x_codes: torch.Tensor, w_codes: torch.Tensor,
                  cfg: MacroConfig, *, key: torch.Generator | None = None,
                  inl_seed: int = 0) -> torch.Tensor:
    """Dispatch on the configured multi-bit scheme: x_codes [..., K]
    unsigned DAC codes, w_codes [K, M] stored codes → ŷ ≈ Σ X̃ W̃ (f32, in
    integer MAC units). Only BP is ported; WBS and BS raise."""
    if cfg.scheme != Scheme.BP:
        raise NotImplementedError(f"scheme {cfg.scheme.value!r} is not "
                                  "ported yet (ROADMAP A8)")
    return bp_mvm(x_codes, w_codes, cfg, key=key, inl_seed=inl_seed)


def signed_correction(y_codes: torch.Tensor, x_codes: torch.Tensor,
                      w_codes: torch.Tensor | None = None, *, w_offset: int,
                      x_zero_point: torch.Tensor,
                      sum_w: torch.Tensor | None = None,
                      k: int | None = None) -> torch.Tensor:
    """Digital correction generalizing Eq. 7 to affine activations.

    With X = s_x (X̃ − z) and W = s_w (W̃ − o):
      Σ X W / (s_x s_w) = Σ X̃ W̃ − o Σ X̃ − z Σ W̃ + o z K
    `sum_w` (with the logical reduction length `k`) stands in for the codes
    when they are not materialized, e.g. nibble-packed weights. Exact
    integer arithmetic in f32.
    """
    if sum_w is None:
        sum_w = torch.sum(w_codes, dim=-2)
    if k is None:
        k = x_codes.shape[-1]
    sum_x = torch.sum(x_codes, dim=-1, keepdim=True)
    return (y_codes - w_offset * sum_x - x_zero_point * sum_w
            + w_offset * x_zero_point * k)
