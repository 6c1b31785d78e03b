"""Monte-Carlo SQNR analysis of CIM schemes (paper §II-A, Eq. 3, Fig. 2).

W, X are 4-bit integers sampled from a truncated Gaussian; y = Σ W X over
K elements; ŷ follows the exact per-scheme computing flow including the
partial-sum accumulation across macros when K > N; SQNR = Σ y² / Σ (y − ŷ)².
Circuit components are ideal (SimLevel.IDEAL) unless the config says
otherwise — the study isolates quantization effects, as the paper does.

The sampler draws from a torch.Generator seeded from `seed`, by the inverse
CDF as jax.random.truncated_normal does; torch cannot reproduce
jax.random's bits, so the codes (and the SQNR in dB) agree with the
reference's in distribution only, within the Monte-Carlo spread.
`_sqnr_batch` takes its codes as arguments, so the same codes can be held
against the reference's flow exactly.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device

from .energy import mvm_energy
from .macro import MacroConfig, Scheme, SimLevel
from .schemes import cim_mvm_codes, exact_mvm_codes, signed_correction


def _truncated_normal(gen: torch.Generator, lower: float, upper: float,
                      shape) -> torch.Tensor:
    """Standard normal truncated to [lower, upper], f32: a uniform draw
    between erf(lower/√2) and erf(upper/√2) through √2·erfinv, clamped to
    the open interval."""
    sqrt2 = math.sqrt(2.0)
    lo, hi = math.erf(lower / sqrt2), math.erf(upper / sqrt2)
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device) * (hi - lo) + lo
    out = sqrt2 * torch.erfinv(u)
    return torch.clamp(out, math.nextafter(lower, math.inf),
                       math.nextafter(upper, -math.inf))


def sample_truncated_gaussian_codes(gen: torch.Generator, shape, bits: int,
                                    signed: bool) -> torch.Tensor:
    """4-bit integers from a truncated Gaussian, as the paper samples W, X.

    Signed codes span [-2^(b-1), 2^(b-1)-1]; unsigned [0, 2^b - 1]. σ is a
    third of the half-range so the distribution is bell-shaped but the
    tails are exercised.
    """
    if signed:
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        sigma = hi / 1.5
        g = _truncated_normal(gen, lo / sigma, hi / sigma, shape) * sigma
    else:
        hi = (1 << bits) - 1
        mean, sigma = hi / 2.0, hi / 3.0
        lo_t, hi_t = (0 - mean) / sigma, (hi - mean) / sigma
        g = _truncated_normal(gen, lo_t, hi_t, shape) * sigma + mean
    return torch.round(g)


@dataclasses.dataclass(frozen=True)
class SqnrResult:
    sqnr_db: float
    energy_per_mvm_j: float
    tops_per_w: float


def _sqnr_batch(cfg: MacroConfig, x: torch.Tensor, w_codes: torch.Tensor,
                offset: int, *, key: torch.Generator | None = None):
    """(Σ y², Σ (y − ŷ)²) over one batch: x [batch, K] unsigned DAC codes,
    w_codes [K, 1] stored codes (signed codes + `offset`, the Eq. 7
    offset, or unsigned with offset 0); `key` draws the converter noise
    away from IDEAL."""
    noise_key = key if cfg.sim_level != SimLevel.IDEAL else None
    y_hat = cim_mvm_codes(x, w_codes, cfg, key=noise_key)
    y_ref = exact_mvm_codes(x, w_codes)
    if offset:
        zp = torch.zeros((), dtype=torch.float32, device=x.device)
        y_hat = signed_correction(y_hat, x, w_codes, w_offset=offset,
                                  x_zero_point=zp)
        y_ref = signed_correction(y_ref, x, w_codes, w_offset=offset,
                                  x_zero_point=zp)
    return torch.sum(y_ref ** 2), torch.sum((y_ref - y_hat) ** 2)


def simulate_sqnr(cfg: MacroConfig, *, k: int = 144, n_samples: int = 1 << 16,
                  batch: int = 1 << 12, seed: int = 0,
                  signed_weights: bool = True,
                  dual_threshold: bool = False,
                  device=None) -> SqnrResult:
    """Monte-Carlo SQNR (Eq. 3) + Eq. 4 energy for one hardware config, on
    `device` (the card unless the caller asks for the CPU).

    dual_threshold defaults to False here: the paper's §II-A analysis uses
    the E_ADC/(N·E_MAC) = 3.0 ratio measured on CAP-RAM [28] (no
    dual-threshold gating); with it, BP/WBS/BS at levels 1024/256/32 are
    exactly iso-energy, as Fig. 2(b) assumes.
    """
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    sig = err = 0.0
    for _ in range(max(1, n_samples // batch)):
        x = sample_truncated_gaussian_codes(gen, (batch, k), cfg.act_bits,
                                            signed=False)
        if signed_weights:
            w_codes = sample_truncated_gaussian_codes(
                gen, (k, 1), cfg.weight_bits, signed=True)
            offset = 1 << (cfg.weight_bits - 1)
            w_codes = w_codes + offset
        else:
            w_codes = sample_truncated_gaussian_codes(
                gen, (k, 1), cfg.weight_bits, signed=False)
            offset = 0
        s, e = _sqnr_batch(cfg, x, w_codes, offset, key=gen)
        sig += float(s)
        err += float(e)
    sqnr_db = 10.0 * math.log10(sig / max(err, 1e-12))
    rep = mvm_energy(cfg, k, dual_threshold=dual_threshold)
    return SqnrResult(sqnr_db=sqnr_db, energy_per_mvm_j=rep.e_mvm_j,
                      tops_per_w=rep.tops_per_w)


def sweep(base: MacroConfig, axis: str, values, **kw) -> list[tuple]:
    """Sweep one MacroConfig field (paper Fig. 2a: n_rows; Fig. 2b:
    adc_levels) for each scheme; returns (scheme, value, SqnrResult)
    tuples. `kw` (device included) goes to simulate_sqnr."""
    out = []
    for scheme in (Scheme.BP, Scheme.WBS, Scheme.BS):
        for v in values:
            cfg = dataclasses.replace(base, scheme=scheme, **{axis: v})
            out.append((scheme.value, v, simulate_sqnr(cfg, **kw)))
    return out
