"""Independent oracle for the grouped ADC MVM kernels (B1/B2).

Mirrors the deterministic (SimLevel.IDEAL) BP transfer: grouped MAC →
per-group ADC clip/round with VTC gain → digital accumulation. Kept
separate from core/schemes.py and from the kernels' plain versions, and
it DIVIDES by the LSB where the kernels multiply by 1/LSB, so it agrees
with them within one ADC step on rounding ties, not bit for bit.
"""
from __future__ import annotations

import torch


def cim_mvm_ref(x_codes: torch.Tensor, w_codes: torch.Tensor, *,
                n_rows: int, levels: int, gain: float,
                full_scale: float) -> torch.Tensor:
    """x_codes [M, K], w_codes [K, N] (K a multiple of n_rows) → [M, N]."""
    m, k = x_codes.shape
    _, n = w_codes.shape
    groups = k // n_rows
    lsb = full_scale / (gain * (levels - 1))
    xg = x_codes.float().reshape(m, groups, n_rows)
    wg = w_codes.float().reshape(groups, n_rows, n)
    part = torch.einsum("mgk,gkn->mgn", xg, wg)
    lsb_t = torch.full((), lsb, dtype=torch.float32, device=part.device)
    code = torch.clamp(torch.round(part / lsb_t), 0.0, float(levels - 1))
    return torch.sum(code * lsb_t, dim=1)
