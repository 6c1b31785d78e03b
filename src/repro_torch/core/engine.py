"""Unified CIM execution engine: one backend registry for every datapath.

Every layer-level matmul (`cim_matmul`, `cim_matmul_prequant`) funnels
through `execute_mvm`, which owns backend selection, the grouped MVM, the
Eq. 7 digital correction and dequantization. Backends differ only in how
the DAC→MAC→ADC core is evaluated:

  backend        what it runs                                   runs on
  -------------  ---------------------------------------------  ---------
  "cuda"         Hopper kernel B2 over dense stored codes        CUDA (its
                 (kernels/csrc/cim_mvm.cu)                        plain
  "cuda_packed"  Hopper kernel B1 over nibble-packed codes,       version on
                 unpacked in registers                            a CPU
                                                                  tensor)
  "plain"        the kernels' plain PyTorch versions, either      any
                 container (the yardstick on the card)

Only the bit-parallel scheme at the IDEAL sim level is ported; the
stochastic converter (ROADMAP A6) and the WBS/BS baselines (ROADMAP A8)
raise NotImplementedError.

`s_w` may be per-matrix or per-output-channel ([..., 1, M]); the Eq. 7
integer correction is scale-free, so per-channel dequant broadcasts
s_w[..., 0, :] over the output after the correction.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import cim_mvm, ops

from .macro import MacroConfig, Scheme, SimLevel
from .schemes import signed_correction


@dataclasses.dataclass(frozen=True)
class PackedCodes:
    """Nibble-packed stored weight codes: two u4 codes per uint8 byte.

    data [..., ceil(K/2), M] uint8 (row 2i low nibble, 2i+1 high); `k` is
    the logical reduction length before pack-padding; `scale` optionally
    carries the dequantization scale(s).
    """

    data: torch.Tensor
    k: int
    scale: torch.Tensor | None = None

    @property
    def n_cols(self) -> int:
        return self.data.shape[-1]


def unpack(weights: PackedCodes) -> torch.Tensor:
    """PackedCodes → dense f32 codes [..., K, M] (drops pack-padding)."""
    return ops.unpack_codes(weights.data, weights.k)


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    name: str
    fn: Callable
    schemes: frozenset
    sim_levels: frozenset
    packed: bool | None = False   # True: PackedCodes; None: either container


_REGISTRY: dict[str, BackendSpec] = {}


def register_backend(name: str, *, schemes, sim_levels, packed=False):
    """Register a backend fn(x_codes, weights, macro) under `name`."""
    def deco(fn):
        _REGISTRY[name] = BackendSpec(name, fn, frozenset(schemes),
                                      frozenset(sim_levels), packed)
        return fn
    return deco


def get_backend(name: str) -> BackendSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown CIM backend {name!r}; "
                         f"registered: {sorted(_REGISTRY)}") from None


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


_BP, _IDEAL = (Scheme.BP,), (SimLevel.IDEAL,)


@register_backend("cuda", schemes=_BP, sim_levels=_IDEAL)
def _cuda_backend(x_codes, w_codes, cfg: MacroConfig):
    return ops.cim_mvm_dense(x_codes, w_codes, cfg)


@register_backend("cuda_packed", schemes=_BP, sim_levels=_IDEAL, packed=True)
def _cuda_packed_backend(x_codes, weights: PackedCodes, cfg: MacroConfig):
    return ops.cim_mvm_packed(x_codes, weights.data, cfg)


@register_backend("plain", schemes=_BP, sim_levels=_IDEAL, packed=None)
def _plain_backend(x_codes, weights, cfg: MacroConfig):
    kw = ops._kernel_kw(cfg)
    if isinstance(weights, PackedCodes):
        x2, w2, lead = ops._prep_packed(x_codes, weights.data)
        out = cim_mvm.cim_mvm_grouped_packed_plain(x2, w2, **kw)
    else:
        x2, w2, lead = ops._prep_dense(x_codes, weights)
        out = cim_mvm.cim_mvm_grouped_plain(x2, w2, **kw)
    return out.reshape(*lead, w2.shape[1])


def _check_ported(macro: MacroConfig) -> None:
    if macro.scheme != Scheme.BP:
        raise NotImplementedError(
            f"scheme {macro.scheme.value!r} is not ported yet (ROADMAP A8)")
    if macro.sim_level != SimLevel.IDEAL:
        raise NotImplementedError(
            f"sim level {macro.sim_level.value!r} is not ported yet "
            "(ROADMAP A6)")


def choose_backend(cfg, x_codes: torch.Tensor, weights) -> str:
    """Resolve cfg.backend ("auto" or explicit) to a registered backend:
    auto picks the Hopper kernel for the weight container ("cuda_packed"
    for PackedCodes, else "cuda")."""
    _check_ported(cfg.macro)
    if cfg.backend != "auto":
        return get_backend(cfg.backend).name
    return "cuda_packed" if isinstance(weights, PackedCodes) else "cuda"


def execute_mvm(x_codes: torch.Tensor, weights, cfg, *, s_x: torch.Tensor,
                s_w: torch.Tensor | None, x_zero_point: torch.Tensor,
                backend: str | None = None) -> torch.Tensor:
    """Run one MVM through the simulated datapath and dequantize.

    x_codes [..., K] unsigned DAC codes; weights are dense stored codes
    [K, M] (float / int8 container) or PackedCodes. Eq. 7's ΣW̃ comes from
    the packed bytes and `k` is the logical K. Returns f32 [..., M].
    """
    macro: MacroConfig = cfg.macro
    _check_ported(macro)
    if getattr(cfg, "noise_seed", None) is not None:
        raise NotImplementedError("seeded stochastic converters are not "
                                  "ported yet (ROADMAP A6)")
    name = backend or choose_backend(cfg, x_codes, weights)
    spec = get_backend(name)
    packed = isinstance(weights, PackedCodes)
    if s_w is None:
        s_w = weights.scale if packed else None
        if s_w is None:
            raise ValueError("execute_mvm needs s_w (or a PackedCodes "
                             "container carrying its scale)")
    if packed and spec.packed is False:
        weights, packed = unpack(weights), False
    elif not packed and spec.packed:
        w_codes = weights.to(torch.float32)
        weights = PackedCodes(ops.pack_codes(w_codes), w_codes.shape[-2])
        packed = True
    if packed:
        y_codes = spec.fn(x_codes, weights, macro)
        sum_w = ops.packed_col_sums(weights.data)
        k = weights.k
    else:
        w_codes = weights.to(torch.float32)
        y_codes = spec.fn(x_codes, w_codes, macro)
        sum_w = torch.sum(w_codes, dim=-2)
        k = w_codes.shape[-2]
    y_int = signed_correction(y_codes, x_codes, None,
                              w_offset=cfg.weight.offset,
                              x_zero_point=x_zero_point, sum_w=sum_w, k=k)
    s_w_out = s_w
    if cfg.weight.per_channel and s_w.ndim >= 2:
        s_w_out = s_w[..., 0, :]
    return y_int * s_x * s_w_out
