"""Bit-Parallel / Weight-Bit-Serial / Bit-Serial analog MVM flows and the
Eq. 7 digital correction.

  BP  (Eq. 1):  ŷ = Σ_g Q_g( Σ_{i∈g} W̃_i X̃_i )                    1 ADC/group
  WBS:          ŷ = Σ_g Σ_p 2^p Q_g( Σ_{i∈g} W^p_i X̃_i )          B_W ADC/group
  BS  (Eq. 2):  ŷ = Σ_g Σ_p Σ_q 2^{p+q} Q_g( Σ_{i∈g} W^p_i X^q_i ) B_A·B_W ADC/group

with groups of N = 144 rows and Q the TD-ADC transfer (core.adc.
adc_quantize, at every sim level) with its full scale matched to the
per-pass operand bit widths.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .adc import adc_quantize
from .macro import MacroConfig, Scheme
from .quant import bit_planes


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


def _grouped_mac(xg: torch.Tensor, wg: torch.Tensor) -> torch.Tensor:
    """Per-group integer MAC: xg [..., G, N] × wg [G, N, M] → [..., G, M],
    exact (integer codes, sums < 2^24)."""
    return torch.einsum("...gn,gnm->...gm", xg, wg)


_SUM_WINDOW = 32


def group_sum(q: torch.Tensor) -> torch.Tensor:
    """Σ over the group axis (-2) of q [..., G, M] in f32, in the order the
    reference's jnp.sum(q, axis=-2) takes on the CPU, so the sum is bit
    for bit the reference's: XLA's tree-reduction rewrite adds up to 32
    groups left to right; past 32 it pads G to whole windows of 32 (the
    padding split pad // 2 before the first group), sums each window left
    to right and reduces the window sums the same way."""
    g = q.shape[-2]
    if g <= _SUM_WINDOW:
        out = q[..., 0, :]
        for i in range(1, g):
            out = out + q[..., i, :]
        return out
    n = -(-g // _SUM_WINDOW)
    first = _SUM_WINDOW - (n * _SUM_WINDOW - g) // 2
    bounds = [0] + [min(first + _SUM_WINDOW * i, g) for i in range(n)]
    parts = [group_sum(q[..., a:b, :]) for a, b in zip(bounds, bounds[1:])
             if b > a]
    return group_sum(torch.stack(parts, dim=-2))


def _adc_sum(v: torch.Tensor, cfg: MacroConfig, key, ba: int, bw: int,
             inl_seed: int) -> torch.Tensor:
    """Quantize each group's analog value and digitally add the groups."""
    q = adc_quantize(v, cfg, key=key, act_bits_active=ba,
                     weight_bits_active=bw, inl_seed=inl_seed)
    return group_sum(q)


def bp_mvm(x_codes: torch.Tensor, w_codes: torch.Tensor, cfg: MacroConfig,
           *, key: torch.Generator | None = None,
           inl_seed: int = 0) -> torch.Tensor:
    """Bit-parallel MVM, written like the reference `schemes.bp_mvm`: one
    einsum over every group, then the ADC transfer (`adc_quantize`, which
    divides by the LSB and, at NOISY/FULL, adds the INL instance and noise
    drawn from the torch.Generator `key`), then the sum over groups in the
    reference's order (`group_sum`). It divides where the kernels multiply
    by 1/LSB and sums groups in another order, so at IDEAL it agrees with
    them within one LSB rounding tie, not bit for bit."""
    xg, _ = pad_and_group(x_codes.float(), cfg.n_rows)
    wg, _ = pad_and_group(w_codes.float(), cfg.n_rows, axis=0)
    return _adc_sum(_grouped_mac(xg, wg), cfg, key, cfg.act_bits,
                    cfg.weight_bits, inl_seed)


def fold_generator(key: torch.Generator | None, salt: int):
    """A generator for one analog pass, seeded from `key`'s initial seed
    and the pass index — where the reference calls fold_in(key, salt)."""
    if key is None:
        return None
    g = torch.Generator(device=key.device)
    g.manual_seed((key.initial_seed() * 1000003 + salt + 1) & 0xFFFFFFFF)
    return g


def wbs_mvm(x_codes: torch.Tensor, w_codes: torch.Tensor, cfg: MacroConfig,
            *, key: torch.Generator | None = None,
            inl_seed: int = 0) -> torch.Tensor:
    """Weight-bit-serial baseline: B_W analog passes over weight bit
    planes, each at the 1-bit weight full scale."""
    xg, _ = pad_and_group(x_codes.float(), cfg.n_rows)
    planes = bit_planes(w_codes.float(), cfg.weight_bits)    # [B_W, K, M]
    out = 0.0
    for p in range(cfg.weight_bits):
        wg, _ = pad_and_group(planes[p], cfg.n_rows, axis=0)
        v = _grouped_mac(xg, wg)
        out = out + (2 ** p) * _adc_sum(v, cfg, fold_generator(key, p),
                                        cfg.act_bits, 1, inl_seed)
    return out


def bs_mvm(x_codes: torch.Tensor, w_codes: torch.Tensor, cfg: MacroConfig,
           *, key: torch.Generator | None = None,
           inl_seed: int = 0) -> torch.Tensor:
    """Fully bit-serial baseline: B_A·B_W binary analog passes (Eq. 2)."""
    x_planes = bit_planes(x_codes.float(), cfg.act_bits)     # [B_A, ..., K]
    w_planes = bit_planes(w_codes.float(), cfg.weight_bits)  # [B_W, K, M]
    out = 0.0
    for p in range(cfg.weight_bits):
        wg, _ = pad_and_group(w_planes[p], cfg.n_rows, axis=0)
        for q in range(cfg.act_bits):
            xg, _ = pad_and_group(x_planes[q], cfg.n_rows)
            v = _grouped_mac(xg, wg)
            out = out + (2 ** (p + q)) * _adc_sum(
                v, cfg, fold_generator(key, p * 16 + q), 1, 1, inl_seed)
    return out


_SCHEME_FNS = {Scheme.BP: bp_mvm, Scheme.WBS: wbs_mvm, Scheme.BS: bs_mvm}


def cim_mvm_codes(x_codes: torch.Tensor, w_codes: torch.Tensor,
                  cfg: MacroConfig, *, key: torch.Generator | None = None,
                  inl_seed: int = 0) -> torch.Tensor:
    """Dispatch on the configured multi-bit scheme: x_codes [..., K]
    unsigned DAC codes, w_codes [K, M] stored codes → ŷ ≈ Σ X̃ W̃ (f32, in
    integer MAC units)."""
    return _SCHEME_FNS[cfg.scheme](x_codes, w_codes, cfg, key=key,
                                   inl_seed=inl_seed)


def exact_mvm_codes(x_codes: torch.Tensor,
                    w_codes: torch.Tensor) -> torch.Tensor:
    """Infinite-resolution reference: y = Σ X̃ W̃ with no ADC, in f32.
    Ground truth for SQNR (Eq. 3)."""
    return torch.einsum("...k,km->...m", x_codes.float(), w_codes.float())


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
