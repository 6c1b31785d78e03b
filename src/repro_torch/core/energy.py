"""Macro energy / throughput / density model (paper Eq. 4, Fig. 21, Table I).

Eq. 4:
    E_MVM = (K/N) · (B_A/b_A) · ( (B_W/b_W) · E_ADC + B_W · N · E_MAC )

where (b_A, b_W) are the bits processed per analog pass:
    BP : (B_A, B_W)  — one ADC per group, all slices in one shot
    WBS: (B_A, 1)    — B_W serial passes, B_W ADC conversions
    BS : (1, 1)      — B_A·B_W passes/conversions

E_MAC is per (b_A-bit input × 1-bit weight) MAC and does NOT scale with b_A
because the C-DAC is driver-free (§II-A); the in-situ analog shift-and-add is
likewise ~free (§III-B).

Absolute calibration anchors (65 nm prototype, Fig. 21):
    40.2 TOPS/W @ 0.65 V and 18.6 TOPS/W @ 1.2 V for 4b×4b BP, N=144
    → E_MAC(0.65 V) solved below; energy ∝ V^1.26 fits both endpoints.

A copy of the JAX package's `core/energy.py`: pure float64 arithmetic on
the macro configuration, no tensors. `core.engine` charges every
execute_mvm call `mvm_energy(macro, K).e_mvm_j` per K-deep dot product
(the per-site counters of `runtime.telemetry`).
"""
from __future__ import annotations

import dataclasses

from .adc import (ADC_RATIO_E_ADC_OVER_N_E_MAC, ADC_RATIO_LEVELS,
                  DUAL_THRESHOLD_GATING)
from .macro import GEOMETRY, MacroConfig, OperatingPoint, Scheme

VOLT_REF = 0.65
# Fitted so that, with the ADC level de-rating at 0.65 V (362 → 256 levels,
# macro.effective_adc_levels), the model hits BOTH measured endpoints:
# 40.2 TOPS/W @ 0.65 V and 18.6 TOPS/W @ 1.2 V (Fig. 21).
_VOLT_EXP = 1.0075


def energy_voltage_scale(vdd: float) -> float:
    return (vdd / VOLT_REF) ** _VOLT_EXP


def _solve_e_mac_ref() -> float:
    """Solve E_MAC at 0.65 V from the 40.2 TOPS/W anchor.

    One BP group MVM: K = N = 144, ops = 2·N (MAC = 2 ops, 4b×4b counting):
        E_group = E_ADC + B_W·N·E_MAC,
        E_ADC   = ratio·N·E_MAC · (levels(0.65 V)/128) · (1 − gating)
        TOPS/W  = 2·144 / E_group = 40.2e12.

    Every ADC-side term is DERIVED from core.adc's measured constants and
    the macro's own level de-rating (362 → 256 effective levels at 0.65 V,
    macro.effective_adc_levels) — the single-source-of-truth contract the
    autotuner's (levels, vdd) sweep relies on: adc_energy_j and this anchor
    can no longer drift apart.
    """
    n = MacroConfig().n_rows
    levels_ref = MacroConfig(
        op=OperatingPoint(vdd=VOLT_REF)).effective_adc_levels()
    adc_factor = ADC_RATIO_E_ADC_OVER_N_E_MAC * n \
        * (levels_ref / ADC_RATIO_LEVELS) * (1.0 - DUAL_THRESHOLD_GATING)
    ops = 2.0 * n
    e_group_target = ops / 40.2e12
    return e_group_target / (adc_factor + 4.0 * n)


E_MAC_REF_J = _solve_e_mac_ref()


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    e_mvm_j: float          # energy of one K-deep, 1-output-column MVM
    e_adc_j: float
    e_mac_j: float
    n_adc_conversions: float
    tops_per_w: float       # at the op counting 1 MAC = 2 ops
    bitwise_tops_per_w: float


def scheme_bits(cfg: MacroConfig) -> tuple[int, int]:
    """(b_A, b_W) per analog pass for the configured scheme."""
    if cfg.scheme == Scheme.BP:
        return cfg.act_bits, cfg.weight_bits
    if cfg.scheme == Scheme.WBS:
        return cfg.act_bits, 1
    return 1, 1


def mvm_energy(cfg: MacroConfig, k: int, *, dual_threshold: bool = True) -> EnergyReport:
    """Eq. 4 for a K-deep dot product on one ADC column."""
    from .adc import adc_energy_j

    b_a, b_w = scheme_bits(cfg)
    groups = max(1, -(-k // cfg.n_rows))  # ceil(K/N): partial-sum macros
    vscale = energy_voltage_scale(cfg.op.vdd)
    e_mac = E_MAC_REF_J * vscale
    e_adc = adc_energy_j(cfg, dual_threshold=dual_threshold)

    passes_a = cfg.act_bits / b_a
    passes_w = cfg.weight_bits / b_w
    n_conv = groups * passes_a * passes_w
    e_mvm = groups * passes_a * (passes_w * e_adc
                                 + cfg.weight_bits * cfg.n_rows * e_mac)

    ops = 2.0 * groups * cfg.n_rows  # padded rows still switch
    tops_w = ops / e_mvm / 1e12
    return EnergyReport(
        e_mvm_j=e_mvm,
        e_adc_j=e_adc,
        e_mac_j=e_mac,
        n_adc_conversions=n_conv,
        tops_per_w=tops_w,
        bitwise_tops_per_w=tops_w * cfg.act_bits * cfg.weight_bits,
    )


def macro_throughput_gops(cfg: MacroConfig) -> float:
    """GOPS of one 8-group macro at the PVT clock (Fig. 21 / Table I).

    Per cycle each of the 8 MVM groups completes one N-row 4b×4b MVM
    (BP: single cycle; WBS/BS: divided by the serial pass count).
    """
    b_a, b_w = scheme_bits(cfg)
    passes = (cfg.act_bits / b_a) * (cfg.weight_bits / b_w)
    ops_per_cycle = GEOMETRY.mvm_groups * 2.0 * cfg.n_rows / passes
    return ops_per_cycle * cfg.clock_hz() / 1e9


def compute_density_tops_mm2(cfg: MacroConfig) -> float:
    return macro_throughput_gops(cfg) / 1e3 / GEOMETRY.area_mm2
