"""Float-in / float-out CIM matmul: the layer-level entry point.

Pipeline (per Eq. 1/7):
  1. activation quantization  — in-situ C-DAC codes X̃ (u4, affine)
  2. weight quantization      — offset-encoded stored codes W̃ (u4)
  3. grouped analog MAC + ADC — kernels B1/B2, or B6/B5 for the
                                 stochastic converter (core.engine)
  4. digital corrections      — Eq. 7 offset/zero-point terms
  5. dequantize               — × s_x s_w

Serving uses `cim_matmul_prequant` against offline-quantized stored codes
(nibble-packed uint8 or an int8 container). The STE training wrapper is
queued with training (ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from .engine import PackedCodes, execute_mvm
from .macro import MacroConfig
from .quant import (ActQuantConfig, WeightQuantConfig, act_scale,
                    quantize_act, quantize_weight, weight_scale)


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    """How (and whether) a model's matmuls run on the simulated macro.

    Field for field the reference's CIMConfig. `noise_seed` names one
    stochastic converter instance (see core.engine). A non-empty
    `site_overrides` (per-site mixed precision, ROADMAP A7) raises until
    its slice lands.
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

    def __post_init__(self):
        if self.site_overrides:
            raise NotImplementedError("per-site precision overrides are not "
                                      "ported yet (ROADMAP A7)")

    def with_scheme(self, scheme) -> "CIMConfig":
        return dataclasses.replace(
            self, macro=dataclasses.replace(self.macro, scheme=scheme))


def cim_matmul(x: torch.Tensor, w: torch.Tensor, cfg: CIMConfig, *,
               key: torch.Generator | None = None,
               inl_seed: int = 0) -> torch.Tensor:
    """Analog-CIM simulation of y = x @ w, quantizing w on the fly.

    x: [..., K] float; w: [K, M] float. Returns float32 [..., M]. `key`
    (a torch.Generator) and `inl_seed` reach the stochastic converter
    (core.engine).
    """
    if not cfg.enabled:
        return x @ w
    s_x = act_scale(x, cfg.act)
    x_codes, zp = quantize_act(x, s_x, cfg.act)
    s_w = weight_scale(w, cfg.weight)
    w_codes = quantize_weight(w, s_w, cfg.weight)
    return execute_mvm(x_codes, w_codes, cfg, s_x=s_x, s_w=s_w,
                       x_zero_point=zp, key=key, inl_seed=inl_seed)


def cim_matmul_prequant(x: torch.Tensor, w_codes, w_scale,
                        cfg: CIMConfig, *, key: torch.Generator | None = None,
                        inl_seed: int = 0) -> torch.Tensor:
    """CIM matmul against OFFLINE-quantized weights (the serving path).

    w_codes: an int8 container [K, M], the nibble-packed uint8 format
    [ceil(K/2), M], or a PackedCodes (w_scale=None then uses its scale).
    """
    s_x = act_scale(x, cfg.act)
    x_codes, zp = quantize_act(x, s_x, cfg.act)
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
    ([..., 1, M]) under cfg.weight.per_channel."""
    wf = w.to(torch.float32)
    dims = (-2,) if cfg.weight.per_channel else (-2, -1)
    amax = torch.amax(wf.abs(), dim=dims, keepdim=True)
    qmax = torch.full((), float(cfg.weight.qmax), dtype=torch.float32,
                      device=wf.device)
    s_w = torch.clamp(amax, min=1e-8) / qmax
    codes = quantize_weight(wf, s_w, cfg.weight)
    return codes.to(torch.int8), s_w.to(torch.float32)

