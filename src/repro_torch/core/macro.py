"""PICO-RAM macro configuration and operating-point (PVT) model.

Mirrors the measured 65-nm prototype (paper §V):
  * 288×144 macro = 8 CIM MVM groups, each 4 slices × 144 clusters × 9 cells
  * N = 144 rows accessed concurrently per analog MVM (computing parallelism)
  * 4-bit activations (in-situ C-DAC) × 4-bit weights (one bit per slice,
    in-situ shift-and-add with 8:4:2:1 capacitive weighting)
  * 8.5-bit dual-threshold time-domain ADC (362 levels), VTC gain 1–4
  * 0.65–1.2 V, −40–105 °C, 2–22 MHz
"""
from __future__ import annotations

import dataclasses
import enum
import math


class Scheme(enum.Enum):
    BP = "bp"    # bit-parallel (this work)
    WBS = "wbs"  # weight-bit-serial baseline
    BS = "bs"    # fully bit-serial baseline


class SimLevel(enum.Enum):
    """Fidelity of the analog simulation.

    IDEAL  — exact transfer curve, no stochastic effects (Fig. 2 SQNR study
             assumption: "ideal circuit components, focus on quantization").
    NOISY  — + thermal noise (σ ≈ 0.4 LSB per conversion, Fig. 16a).
    FULL   — + INL curve and gain error (Fig. 15/17), PVT-scaled (Fig. 18).
    """

    IDEAL = "ideal"
    NOISY = "noisy"
    FULL = "full"


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """Supply voltage / temperature point (the paper's PVT axes)."""

    vdd: float = 0.9        # V, 0.65–1.2
    temp_c: float = 25.0    # °C, −40–105

    def __post_init__(self):
        if not (0.6 <= self.vdd <= 1.25):
            raise ValueError(f"vdd {self.vdd} outside the measured 0.65–1.2 V range")
        if not (-45.0 <= self.temp_c <= 110.0):
            raise ValueError(f"temp {self.temp_c} outside the measured −40–105 °C range")


@dataclasses.dataclass(frozen=True)
class MacroConfig:
    """Static configuration of one simulated PICO-RAM macro."""

    n_rows: int = 144            # N: rows accessed concurrently (one slice)
    act_bits: int = 4            # B_A (C-DAC resolution)
    weight_bits: int = 4         # B_W (slices per MVM group)
    adc_levels: int = 362        # 8.5-bit dual-threshold TD-ADC (2^8.5 ≈ 362)
    gain: float = 1.0            # VTC gain, 1–4 (Fig. 15)
    scheme: Scheme = Scheme.BP
    sim_level: SimLevel = SimLevel.IDEAL
    op: OperatingPoint = dataclasses.field(default_factory=OperatingPoint)

    # Calibrated noise parameters (LSB units, gain=1, 0.9 V, 25 °C).
    # Paper Fig. 16 measures σ at the OUTPUT CODES: thermal RMS 0.4 LSB and
    # total σ_E 0.59 LSB *including* the quantizer's own rounding variance
    # (≈1/12 LSB²). The injected pre-rounding σ is therefore
    # √(0.40² − 1/12) ≈ 0.277 — benchmarks/fig16_noise.py verifies the
    # measured output σ reproduces the paper's 0.40 / 0.59.
    sigma_thermal_lsb: float = 0.277
    inl_amp_lsb: float = 1.10     # end-to-end |INL| bound (Fig. 15)
    dnl_amp_lsb: float = 0.50     # |DNL| bound ≈ +0.56/−0.41 (Fig. 15)

    def __post_init__(self):
        if self.gain < 1.0 or self.gain > 4.0:
            raise ValueError(f"VTC gain {self.gain} outside the 1–4 range")
        if self.adc_levels < 2:
            raise ValueError("adc_levels must be ≥ 2")

    # ---- derived quantities -------------------------------------------------
    @property
    def act_qmax(self) -> int:
        return (1 << self.act_bits) - 1

    @property
    def weight_qmax_unsigned(self) -> int:
        return (1 << self.weight_bits) - 1

    @property
    def adc_bits(self) -> float:
        return math.log2(self.adc_levels)

    def full_scale(self, act_bits_active: int | None = None,
                   weight_bits_active: int | None = None) -> float:
        """Maximum analog MAC level before the ADC for the active bit widths.

        BP drives b_A-bit DAC codes against b_W-bit (offset-encoded) weights:
          FS = (2^b_A − 1)(2^b_W − 1) N.
        WBS/BS pass binary planes on one or both operands, shrinking FS — the
        paper's point is that this does NOT buy accuracy once the digital
        accumulation of per-plane ADC errors is accounted for (§II-A).
        """
        ba = self.act_bits if act_bits_active is None else act_bits_active
        bw = self.weight_bits if weight_bits_active is None else weight_bits_active
        return float(((1 << ba) - 1) * ((1 << bw) - 1) * self.n_rows)

    def adc_lsb(self, act_bits_active: int | None = None,
                weight_bits_active: int | None = None) -> float:
        """Analog units per ADC code, including the VTC gain.

        gain > 1 amplifies the MAC voltage before time conversion, shrinking
        the LSB (finer quantization) while clipping the (rarely reached) top
        of the range — paper Fig. 15/18 and §V-A.
        """
        fs = self.full_scale(act_bits_active, weight_bits_active)
        return fs / (self.gain * (self.adc_levels - 1))

    # ---- PVT behavioural model (calibrated to Fig. 18 / Fig. 21) -----------
    def effective_adc_levels(self) -> int:
        """At 0.65 V the ADC input range shrinks → resolution degrades to
        ~8 bit (paper §V-B). Linear de-rating below 0.75 V."""
        if self.op.vdd >= 0.75:
            return self.adc_levels
        frac = (self.op.vdd - 0.65) / 0.10  # 0 at 0.65 V → 1 at 0.75 V
        lo = 256  # 8-bit floor measured at 0.65 V
        return int(round(lo + frac * (self.adc_levels - lo)))

    def sigma_e_lsb(self) -> float:
        """Total computing-error σ_E in LSB (noise + nonlinearity), PVT-scaled.

        Calibration anchors: σ_E = 0.59 LSB @ (0.9 V, 25 °C, gain 1); Fig. 18
        shows mild growth toward the voltage/temperature corners and Fig. 18's
        gain study shows σ_E grows sublinearly with gain (reference-current
        noise): we fit σ_E(gain) ≈ σ_E·gain^0.35 so that σ_E×LSB_volts still
        *shrinks* with gain, matching the paper's conclusion that higher gain
        is a net win.
        """
        base = 0.59
        v = self.op.vdd
        t = self.op.temp_c
        v_term = 1.0 + 0.55 * max(0.0, 0.80 - v) / 0.15 + 0.10 * max(0.0, v - 1.1)
        t_term = 1.0 + 0.0016 * abs(t - 25.0)
        g_term = self.gain ** 0.35
        return base * v_term * t_term * g_term

    def sigma_thermal(self) -> float:
        """Thermal-only σ (Fig. 16a), PVT-scaled like σ_E."""
        return self.sigma_thermal_lsb * (self.sigma_e_lsb() / 0.59)

    def clock_hz(self) -> float:
        """~Linear 0.65→1.2 V clock (Fig. 21: "2 MHz"→22 MHz). The low end is
        fitted to the measured 3.8 GOPS @ 0.65 V (Table I): 8 groups × 288
        ops × f = 3.8 GOPS → f = 1.65 MHz (the text's 2 MHz is rounded)."""
        return (1.65 + (self.op.vdd - 0.65) / 0.55 * 20.35) * 1e6


# The paper's prototype macro geometry (for area/density/energy accounting).
@dataclasses.dataclass(frozen=True)
class MacroGeometry:
    mvm_groups: int = 8          # TD-ADCs per macro
    slices_per_group: int = 4    # weight bits
    clusters_per_slice: int = 144
    cells_per_cluster: int = 9   # 9 × 6T cells share one MAC unit
    capacity_kb: float = 40.5    # 288 × 144 bits
    area_mm2: float = 0.074
    area_frac_array: float = 0.709
    area_frac_drivers: float = 0.147
    area_frac_adc: float = 0.046

    @property
    def density_kb_mm2(self) -> float:
        return self.capacity_kb / self.area_mm2


PROTOTYPE = MacroConfig()
GEOMETRY = MacroGeometry()
