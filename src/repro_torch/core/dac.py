"""In-situ capacitive DAC behavioural model (paper §III-C).

The C-DAC reuses the cluster MOM capacitors as a two-phase capacitive voltage
divider (16/8/4/2 clusters per column group encode the 4 input bits), so:

  * it is buffer-free and PVT-insensitive (pure charge redistribution) — in
    the simulation the DAC transfer is exactly linear;
  * its energy is *input-sparsity aware*: a capacitor is only charged when
    the corresponding input bit is 1 (measured 2.4 %–14.6 % of macro energy).

Functionally the DAC is the activation quantizer (quant.quantize_act); this
module adds the energy/statistics model.
"""
from __future__ import annotations

import torch

from .macro import MacroConfig


def dac_codes(x_q: torch.Tensor) -> torch.Tensor:
    """Identity transfer: codes in [0, 2^B_A − 1] → ideal analog levels
    (capacitor mismatch is folded into the end-to-end INL model, adc.py)."""
    return x_q


def dac_switched_cap_fraction(x_q: torch.Tensor,
                              cfg: MacroConfig) -> torch.Tensor:
    """Fraction of DAC capacitance charged for given codes ∈ [0, qmax]:
    bit b switches a bank proportional to 2^b; zero inputs charge
    nothing."""
    qi = x_q.to(torch.int32)
    weights = torch.tensor([2 ** b for b in range(cfg.act_bits)],
                           dtype=torch.float32, device=x_q.device)
    bits = torch.stack([(qi >> b) & 1 for b in range(cfg.act_bits)],
                       -1).to(torch.float32)
    return (bits @ weights) / float(cfg.act_qmax)


def dac_energy_j(x_q: torch.Tensor, cfg: MacroConfig) -> torch.Tensor:
    """DAC energy for one group conversion (all N row DACs), given the code
    statistics in x_q: the DAC share of total group energy spans the
    measured 2.4 %–14.6 % between sparse (90 % zeros) and dense inputs."""
    from .energy import E_MAC_REF_J, VOLT_REF, energy_voltage_scale

    # per-row full-code charge ≈ 2.4× one MAC event
    e_row_full = 2.4 * E_MAC_REF_J
    scale = energy_voltage_scale(cfg.op.vdd) / energy_voltage_scale(VOLT_REF)
    mean_frac = torch.mean(dac_switched_cap_fraction(x_q, cfg))
    return cfg.n_rows * mean_frac * e_row_full * scale
