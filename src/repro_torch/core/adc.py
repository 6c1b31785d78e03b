"""Dual-threshold time-domain ADC behavioural model (paper §IV).

    code = clip( round( v/LSB + INL(v) + ε_thermal ), 0, levels−1 )

with LSB = full scale / (gain × (levels−1)), a smooth bounded INL curve
(Fig. 15: ±1.10 LSB end to end) and Gaussian thermal noise (Fig. 16a).

`inl_curve` evaluates the reference's INL instance in the order the fused
stochastic kernels use (B5/B6, `kernels/cim_mvm.py`): the instance's
constants come from the same numpy RandomState draws, computed in float64
and rounded to f32 once, and the multiply-adds that XLA contracts into
fused multiply-adds when it runs the reference kernel are fused here too
(`fma_f32`). `sin` is each framework's own, so FULL agrees with the
reference only to a stated tolerance (tests/test_torch_noisy.py).

`adc_energy_j` is the converter's share of the Eq. 4 energy model
(`core/energy.py`), pure float64 arithmetic as in the reference. The
straight-through estimators of QAT wait for training (ROADMAP A10).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .macro import MacroConfig, SimLevel
from .quant import _f32

# --- measured ADC constants (the reference's single source of truth) -------
# Every consumer (adc_energy_j below, energy._solve_e_mac_ref's absolute
# anchor) derives from THESE.
#
# Dual-threshold comparator power-gating probability (§IV, measured): the
# main conversion path is off 55.8 % of the time.
DUAL_THRESHOLD_GATING = 0.558
# Eq. 4 ratio anchor: E_ADC/(N·E_MAC) = 3.0 at 7-bit (128-level) resolution
# with N = 144 rows.
ADC_RATIO_E_ADC_OVER_N_E_MAC = 3.0
ADC_RATIO_LEVELS = 128.0
ADC_RATIO_N_ROWS = 144


def fma_f32(a, b, c: torch.Tensor) -> torch.Tensor:
    """round_f32(a·b + c) with one rounding, as a fused multiply-add gives
    it, for f32 operands (tensors or f32-valued Python floats).

    The product is exact in float64 (24 + 24 bits); the float64 sum s and
    its exact error e come from TwoSum. Rounding s to f32 is the FMA's
    result unless s lies exactly halfway between two f32 values while
    e ≠ 0: then the exact sum lies on e's side of the tie."""
    a64 = a.double() if torch.is_tensor(a) else a
    b64 = b.double() if torch.is_tensor(b) else b
    p = a64 * b64
    c64 = c.double()
    s = p + c64
    bv = s - p
    e = (p - (s - bv)) + (c64 - bv)
    r = s.float()
    rd = r.double()
    other = 2.0 * s - rd            # the f32 neighbour across s, if s is a tie
    tie = (other != rd) & (other.float().double() == other)
    away = torch.sign(e) * torch.sign(other - rd) > 0
    return torch.where(tie & away, other.float(), r)


class InlInstance(NamedTuple):
    """One INL instance's constants, each rounded to f32 once."""

    sign: float
    ripple0: float
    ripple1: float
    phase0: float
    phase1: float
    norm: float        # 1 + |ripple0| + |ripple1|
    bow: float         # (amp − jitter amp) · scale
    jitter: float      # jitter amplitude
    two_pi: float


def _to_f32(v: float) -> float:
    return float(np.float32(v))


@functools.lru_cache(maxsize=256)
def inl_instance(amp_lsb: float, seed: int = 0) -> InlInstance:
    """The reference's `inl_curve` constants for (amp_lsb, seed): the same
    RandomState(seed·7919 + 13) draws in the same order, combined in
    float64 exactly as the reference combines them, then rounded to f32."""
    rng = np.random.RandomState(seed * 7919 + 13)
    sign = 1.0 if rng.rand() < 0.5 else -1.0
    ripple_w = 0.12 * rng.randn(2)
    ph = rng.uniform(0, 2 * np.pi, size=2)
    scale = 0.85 + 0.15 * rng.rand()
    norm = 1.0 + abs(float(ripple_w[0])) + abs(float(ripple_w[1]))
    jit_amp = min(0.24, 0.2 * amp_lsb)
    return InlInstance(
        sign=sign, ripple0=_to_f32(ripple_w[0]), ripple1=_to_f32(ripple_w[1]),
        phase0=_to_f32(ph[0]), phase1=_to_f32(ph[1]), norm=_to_f32(norm),
        bow=_to_f32((amp_lsb - jit_amp) * scale), jitter=_to_f32(jit_amp),
        two_pi=_to_f32(2 * math.pi))


def inl_curve(code_frac: torch.Tensor, amp_lsb: float,
              seed: int = 0) -> torch.Tensor:
    """Deterministic smooth INL profile in LSB of code ∈ [0, 1] (f32): a
    cubic bow peaking at the range ends, a small mid-range ripple and a
    high-frequency per-code jitter (the reference's `inl_curve`).

    u³ is u·(u·u), as XLA's integer_pow evaluates it; every multiply-add
    is fused (`fma_f32`) where XLA fuses it in the reference kernel."""
    c = inl_instance(float(amp_lsb), int(seed))
    cf = code_frac.float()
    u = cf * 2.0 - 1.0
    xa = cf * c.two_pi
    s1 = torch.sin(xa * 2.0 + c.phase0)
    s2 = torch.sin(fma_f32(3.0, xa, _f32(c.phase1, cf)))
    curve = fma_f32(c.ripple1, s2, fma_f32(c.ripple0, s1, u * (u * u)
                                           * c.sign))
    curve = curve / _f32(c.norm, cf)
    j1 = torch.sin(fma_f32(cf, 12289.0, _f32(c.phase0, cf)))
    j2 = torch.sin(fma_f32(cf, 5741.0, _f32(c.phase1, cf)))
    return fma_f32(j1 * c.jitter, j2, curve * c.bow)


def stochastic_transfer_params(cfg: MacroConfig) -> dict:
    """σ / INL settings of the stochastic ADC transfer for cfg.sim_level,
    shared by `adc_quantize` and the fused kernels B5/B6:

      NOISY → σ = sigma_thermal_lsb (0.277 pre-rounding), no INL;
      FULL  → σ = sigma_thermal() (PVT-scaled), + the Fig. 15 INL curve.
    """
    if cfg.sim_level == SimLevel.FULL:
        return {"sigma": float(cfg.sigma_thermal()), "apply_inl": True,
                "inl_amp": float(cfg.inl_amp_lsb)}
    return {"sigma": float(cfg.sigma_thermal_lsb), "apply_inl": False,
            "inl_amp": 0.0}


def adc_quantize(v_analog: torch.Tensor, cfg: MacroConfig, *,
                 key: torch.Generator | None = None,
                 act_bits_active: int | None = None,
                 weight_bits_active: int | None = None,
                 inl_seed: int = 0) -> torch.Tensor:
    """Quantize analog MAC values (integer MAC units) through the TD-ADC
    transfer; returns the reconstructed value code × LSB.

    `key` is a torch.Generator on v_analog's device, the counterpart of the
    reference's jax.random key: the thermal term is σ·torch.randn drawn
    from it. Its draws differ from jax.random's, so the two agree in
    distribution, not draw for draw. Without a key no noise is added (the
    INL still applies at FULL).
    """
    levels = cfg.effective_adc_levels()
    lsb = cfg.full_scale(act_bits_active, weight_bits_active) \
        / (cfg.gain * (levels - 1))
    x = v_analog / _f32(lsb, v_analog)
    if cfg.sim_level != SimLevel.IDEAL:
        st = stochastic_transfer_params(cfg)
        if st["apply_inl"]:
            frac = torch.clamp(x / _f32(float(levels), x), 0.0, 1.0)
            x = x + inl_curve(frac, st["inl_amp"], inl_seed)
        if key is not None:
            x = x + _to_f32(st["sigma"]) * torch.randn(
                x.shape, generator=key, dtype=x.dtype, device=x.device)
    code = torch.clamp(torch.round(x), 0.0, float(levels - 1))
    return code * _f32(lsb, code)


def adc_energy_j(cfg: MacroConfig, *, dual_threshold: bool = True) -> float:
    """Energy of one TD-ADC conversion (behavioural, calibrated).

    TD-ADC energy scales ~linearly with quantization levels (paper §II-C /
    Walden). The dual-threshold comparator power-gates the main path for a
    measured 55.8 % reduction (§IV). Absolute scale is anchored so that the
    full Eq. 4 macro model reproduces 40.2 TOPS/W @ 0.65 V (see energy.py).
    """
    from .energy import E_MAC_REF_J, VOLT_REF, energy_voltage_scale

    e_adc_7b = ADC_RATIO_E_ADC_OVER_N_E_MAC * ADC_RATIO_N_ROWS * E_MAC_REF_J
    levels = cfg.effective_adc_levels()
    e = e_adc_7b * (levels / ADC_RATIO_LEVELS)
    if dual_threshold:
        e *= (1.0 - DUAL_THRESHOLD_GATING)
    return e * energy_voltage_scale(cfg.op.vdd) / energy_voltage_scale(VOLT_REF)
