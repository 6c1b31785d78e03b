"""Float-in / float-out CIM matmul: the layer-level entry point.

Pipeline (per Eq. 1/7):
  1. activation quantization  — in-situ C-DAC codes X̃ (u4, affine)
  2. weight quantization      — offset-encoded stored codes W̃ (u4)
  3. grouped analog MAC + ADC — kernels B1/B2, or B6/B5 for the
                                 stochastic converter (core.engine)
  4. digital corrections      — Eq. 7 offset/zero-point terms
  5. dequantize               — × s_x s_w

Serving uses `cim_matmul_prequant` against offline-quantized stored codes
(nibble-packed uint8 or an int8 container). Each entry point first
resolves the enclosing `quant.act_site` through `CIMConfig.site_overrides`
(`resolve_site_cfg`), so a precision manifest's per-site grid, ADC levels,
scheme and per-channel scales reach the engine and the kernels.

Training uses `cim_matmul_ste`: an autograd.Function whose forward is the
whole analog pipeline (`cim_matmul`, kernel B2 on the card) and whose
backward is the float matmul's (the paper's STE QAT, §II-B: BP needs this
one quantization step and no bit-level GSTE). `cim_matmul` itself stays
differentiable through its STE quantizers and the engine's einsum VJP.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from .engine import PackedCodes, execute_mvm
from .macro import MacroConfig, Scheme
from .quant import (ActQuantConfig, WeightQuantConfig, act_scale,
                    annotate_recorded_shape, current_site, quantize_act,
                    quantize_weight, quantize_weight_experts,
                    recording_active, weight_scale)


@dataclasses.dataclass(frozen=True)
class SitePrecision:
    """Per-call-site precision override (one entry of a mixed-precision
    deployment manifest, analysis.precision_search). Every field is
    optional; None keeps the uniform base config's value. Frozen and
    hashable, so it rides CIMConfig inside the `site_overrides` tuple."""

    act_scale: float | None = None     # static DAC grid scale
    act_zero_point: float | None = None
    adc_levels: int | None = None      # per-site ADC resolution
    scheme: str | None = None          # "bp" | "wbs" | "bs" (macro.Scheme)
    per_channel: bool | None = None    # per-output-channel weight scales

    def apply(self, cfg: "CIMConfig") -> "CIMConfig":
        macro, act, weight = cfg.macro, cfg.act, cfg.weight
        if self.adc_levels is not None:
            macro = dataclasses.replace(macro, adc_levels=self.adc_levels)
        if self.scheme is not None:
            macro = dataclasses.replace(macro, scheme=Scheme(self.scheme))
        if self.act_scale is not None:
            act = dataclasses.replace(
                act, static_scale=self.act_scale,
                static_zero_point=self.act_zero_point or 0.0)
        elif self.act_zero_point is not None:
            act = dataclasses.replace(act,
                                      static_zero_point=self.act_zero_point)
        if self.per_channel is not None:
            weight = dataclasses.replace(weight,
                                         per_channel=self.per_channel)
        return dataclasses.replace(cfg, macro=macro, act=act, weight=weight)


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    """How (and whether) a model's matmuls run on the simulated macro.

    Field for field the reference's CIMConfig. `noise_seed` names one
    stochastic converter instance (see core.engine). `site_overrides` is
    the mixed-precision deployment tree, ((site_name, SitePrecision), ...)
    — a tuple of pairs so the config stays hashable; sites without an
    entry run the uniform base config.
    """

    enabled: bool = False
    macro: MacroConfig = dataclasses.field(default_factory=MacroConfig)
    act: ActQuantConfig = dataclasses.field(default_factory=ActQuantConfig)
    weight: WeightQuantConfig = dataclasses.field(
        default_factory=WeightQuantConfig)
    backend: Literal["auto", "einsum", "scan", "cuda", "cuda_packed",
                     "cuda_noisy", "cuda_noisy_packed", "plain"] = "auto"
    noise_seed: int | None = None
    site_overrides: tuple = ()

    def with_scheme(self, scheme) -> "CIMConfig":
        return dataclasses.replace(
            self, macro=dataclasses.replace(self.macro, scheme=scheme))

    def for_site(self, site: str | None) -> "CIMConfig":
        """The effective config at a named call site (the uniform base when
        the site has no override or is unnamed)."""
        if site is not None:
            for name, ov in self.site_overrides:
                if name == site:
                    return ov.apply(
                        dataclasses.replace(self, site_overrides=()))
        return dataclasses.replace(self, site_overrides=()) \
            if self.site_overrides else self


# (id(cfg), site) -> (cfg, resolved). The reference resolves a site once,
# at trace time; the eager port resolves on every MVM, so the resolved
# config is cached. The entry holds cfg itself, so its id cannot be reused
# while the entry lives, and a hit is checked by identity.
_SITE_CFG_CACHE: dict = {}
_SITE_CFG_CACHE_MAX = 4096


def resolve_site_cfg(cfg: CIMConfig) -> CIMConfig:
    """Per-site override resolution at the quantization entry points: maps
    the enclosing quant.act_site scope through cfg.site_overrides."""
    if not cfg.site_overrides:
        return cfg
    site = current_site()
    key = (id(cfg), site)
    hit = _SITE_CFG_CACHE.get(key)
    if hit is not None and hit[0] is cfg:
        return hit[1]
    if len(_SITE_CFG_CACHE) >= _SITE_CFG_CACHE_MAX:
        _SITE_CFG_CACHE.clear()
    resolved = cfg.for_site(site)
    _SITE_CFG_CACHE[key] = (cfg, resolved)
    return resolved


OFF = CIMConfig(enabled=False)
BP_IDEAL = CIMConfig(enabled=True)


def cim_matmul(x: torch.Tensor, w: torch.Tensor, cfg: CIMConfig, *,
               key: torch.Generator | None = None,
               inl_seed: int = 0) -> torch.Tensor:
    """Analog-CIM simulation of y = x @ w, quantizing w on the fly.

    x: [..., K] float; w: [K, M] float. Returns float32 [..., M]. `key`
    (a torch.Generator) and `inl_seed` reach the stochastic converter
    (core.engine).

    Expert-batched (the MoE routed experts): x [E, C, K] with w [E, K, M]
    → [E, C, M]. Each expert is quantized on its own dynamic activation
    grid and its own weight scale ([E, 1, 1], or [E, 1, M] per channel),
    as the reference's vmap over the expert axis computes; w may stay in
    the model dtype, and its codes are made a few experts at a time into
    one f32 container (quant.quantize_weight_experts). The engine runs
    the expert-batched entry of B2 / B5 (one launch).
    """
    if not cfg.enabled:
        return x @ w
    cfg = resolve_site_cfg(cfg)
    experts = w.ndim == 3
    s_x = act_scale(x, cfg.act, per_expert=experts)
    if recording_active():
        annotate_recorded_shape(w.shape[-1])
    x_codes, zp = quantize_act(x, s_x, cfg.act, per_expert=experts)
    s_w = weight_scale(w, cfg.weight, per_expert=experts)
    w_codes = quantize_weight_experts(w, s_w, cfg.weight) if experts \
        else quantize_weight(w, s_w, cfg.weight)
    return execute_mvm(x_codes, w_codes, cfg, s_x=s_x, s_w=s_w,
                       x_zero_point=zp, key=key, inl_seed=inl_seed)


def cim_matmul_prequant(x: torch.Tensor, w_codes, w_scale,
                        cfg: CIMConfig, *, key: torch.Generator | None = None,
                        inl_seed: int = 0) -> torch.Tensor:
    """CIM matmul against OFFLINE-quantized weights (the serving path).

    w_codes: an int8 container [K, M], the nibble-packed uint8 format
    [ceil(K/2), M], or a PackedCodes (w_scale=None then uses its scale).
    w_scale is per-matrix or per-output-channel ([..., 1, M]).

    Expert-batched (the MoE routed experts): x [E, C, K] with a PackedCodes
    of data [E, K2, M] or an int8 container [E, K, M], scales [E, 1, 1] or
    [E, 1, M] → [E, C, M]. Each expert is quantized on its own dynamic
    activation grid, as the reference's vmap over the expert axis does;
    the engine runs B1/B6's expert-batched entry (one launch).
    """
    cfg = resolve_site_cfg(cfg)
    data = w_codes.data if isinstance(w_codes, PackedCodes) else w_codes
    experts = data.ndim == 3
    s_x = act_scale(x, cfg.act, per_expert=experts)
    x_codes, zp = quantize_act(x, s_x, cfg.act, per_expert=experts)
    if isinstance(w_codes, PackedCodes):
        weights = w_codes if w_scale is None \
            else PackedCodes(w_codes.data, w_codes.k, w_scale)
    elif w_codes.dtype == torch.uint8:   # nibble-packed wire format
        weights = PackedCodes(w_codes, x.shape[-1], w_scale)
    else:
        weights = w_codes.to(torch.float32)
    return execute_mvm(x_codes, weights, cfg, s_x=s_x, s_w=w_scale,
                       x_zero_point=zp, key=key, inl_seed=inl_seed)


def quantize_weight_offline(w: torch.Tensor, cfg: CIMConfig):
    """bf16/f32 weight → (int8 stored codes, f32 scale) for the prequant
    path: one scale per matrix ([..., 1, 1]), or per output channel
    ([..., 1, M]) under cfg.weight.per_channel — per site, since
    models.quantize pushes the weight name as the site."""
    wf = w.to(torch.float32)
    cfg = resolve_site_cfg(cfg)
    dims = (-2,) if cfg.weight.per_channel else (-2, -1)
    amax = torch.amax(wf.abs(), dim=dims, keepdim=True)
    qmax = torch.full((), float(cfg.weight.qmax), dtype=torch.float32,
                      device=wf.device)
    s_w = torch.clamp(amax, min=1e-8) / qmax
    codes = quantize_weight(wf, s_w, cfg.weight)
    return codes.to(torch.int8), s_w.to(torch.float32)


# ---------------------------------------------------------------------------
# STE (QAT) wrapper: analog forward, float-matmul backward
# ---------------------------------------------------------------------------
class _STEMatmul(torch.autograd.Function):
    """Forward: `cim_matmul` (no autograd graph inside: the kernel runs as
    it does at inference). Backward: the float matmul's (the reference's
    `_ste_bwd`), cast to x's and w's dtypes; no second analog forward.

    2-D w [K, M]: gx = g·wᵀ, gw = xᵀ·g summed over x's leading axes.
    Expert-batched w [E, K, M] with x [E, C, K]: per expert, gx[e] =
    g[e]·w[e]ᵀ and gw[e] = x[e]ᵀ·g[e], as the reference's vmap of
    `_ste_bwd` gives them. The expert stack may stay in the model dtype
    (only it is saved, no f32 copy): the products run in f32, and gw is
    rounded to w's dtype last, as the reference's f32 cast of w before its
    STE rounds its f32 gradient in the cast's VJP."""

    @staticmethod
    def forward(ctx, x, w, cfg, key, inl_seed):
        ctx.save_for_backward(x, w)
        return cim_matmul(x, w, cfg, key=key, inl_seed=inl_seed)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if w.ndim == 3:
            g = g.float()
            if ctx.needs_input_grad[0]:
                gx = torch.matmul(g, w.float().transpose(1, 2)).to(x.dtype)
            if ctx.needs_input_grad[1]:
                gw = torch.matmul(x.float().transpose(1, 2), g).to(w.dtype)
            return gx, gw, None, None, None
        if ctx.needs_input_grad[0]:
            gx = (g @ w.T).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = (x.reshape(-1, x.shape[-1]).T
                  @ g.reshape(-1, g.shape[-1])).to(w.dtype)
        return gx, gw, None, None, None


def cim_matmul_ste(x: torch.Tensor, w: torch.Tensor, cfg: CIMConfig, *,
                   key: torch.Generator | None = None,
                   inl_seed: int = 0) -> torch.Tensor:
    """CIM forward value with float-matmul gradients: x [..., K] float, w
    [K, M] float → f32 [..., M], the value `cim_matmul`'s, the gradient
    d(x @ w)'s (Eq. 5's identity-derivative quantizers compose to exactly
    this). Expert-batched, x [E, C, K] with w [E, K, M] (float, the model
    dtype allowed) → [E, C, M]: one expert-batched call forward (B2e on
    the card), per-expert products backward. With CIM off it is x @ w."""
    if not cfg.enabled:
        return x @ w
    return _STEMatmul.apply(x, w, cfg, key, inl_seed)
