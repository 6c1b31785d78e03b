"""Unified CIM execution engine: one backend registry for every datapath.

Every layer-level matmul (`cim_matmul`, `cim_matmul_prequant`) funnels
through `execute_mvm`, which owns backend selection, the grouped MVM, the
Eq. 7 digital correction and dequantization. Backends differ only in how
the DAC→MAC→ADC core is evaluated:

  backend              what it runs                              runs on
  -------------------  ----------------------------------------  ---------
  "einsum"             the whole [.., G, M] pre-ADC tensor at     any; small
                       once, then one vectorized ADC transfer     layers /
                       (core.adc.adc_quantize; every sim level)   tests
  "scan"               the same group by group, O(M) live memory  any; large
                                                                  layers
  "cuda"               Hopper kernel B2 over dense stored codes    CUDA (its
                       (kernels/csrc/cim_mvm.cu), IDEAL transfer   plain
  "cuda_packed"        kernel B1 over nibble-packed codes          version on
  "cuda_noisy"         kernel B5: B2 with the NOISY/FULL           a CPU
                       converter, noise drawn in the kernel from   tensor)
                       a counter hash of (seed, coordinate, group)
  "cuda_noisy_packed"  kernel B6: B5 over nibble-packed codes,
                       bit-identical to B5 under one seed
  "plain"              the kernels' plain PyTorch versions, either any
                       container and every sim level (the
                       yardstick on the card); WBS/BS on einsum

The kernels implement the bit-parallel scheme; the WBS/BS baselines run on
the einsum backend (schemes.wbs_mvm / bs_mvm), as the reference's
choose_backend routes them. A per-site override (cim_matmul.
resolve_site_cfg) reaches this module as the resolved config, so the
dispatch hook charges energy under the site's own macro and the kernels
get the site's ADC levels.

noise_seed semantics
--------------------
`CIMConfig.noise_seed` (or `noise_seed=` on `execute_mvm`) names one
stochastic instance of the converter chain, as in the reference:

  * auto + BP + NOISY/FULL + noise_seed → "cuda_noisy[_packed]"; without a
    seed the eager backends (einsum, or scan past 64 MB of pre-ADC tensor)
    run, drawing noise from the optional `key`.
  * A seed is bit-reproducible: outputs are a pure function of (operands,
    config, noise_seed, inl_seed). So two same-shaped MVMs under one
    (noise_seed, inl_seed) draw the SAME noise realization, by design; the
    serving path shares one realization per shape, as the reference does.
  * `key` is a torch.Generator, the counterpart of the reference's
    jax.random key. Given only a noise_seed, einsum/scan derive a
    generator seeded with salt_seed(noise_seed, inl_seed), the counterpart
    of the reference's fold_in(PRNGKey(noise_seed), inl_seed), so they are
    seeded-reproducible too. torch's draws differ from jax.random's, so
    the eager backends agree with the reference (and with the kernels) in
    distribution only; the kernels' counter hash is bit-exact against the
    reference's Pallas kernels.

Gradients
---------
The kernel backends ("cuda*") and their plain versions ("plain") have no
autograd of their own: the kernels fill their output through ctypes, and
the plain versions round with torch.round. When an operand carries a
gradient, `execute_mvm` runs them inside `_EinsumVJP`, an
autograd.Function whose forward is the backend itself (one launch, as
without it) and whose backward is the autograd of the "einsum" backend on
the same codes with no key (the reference's `custom_vjp`s,
`_pallas_mvm_bwd` and its stochastic and packed twins): its STE round and
clip make dŷ/dX̃ = W̃ᵀ group by group. Stored codes (PackedCodes) and the
seed get no gradient. A backward launches no MVM kernel. Without an
operand that needs a gradient the backend is called directly.

`s_w` may be per-matrix or per-output-channel ([..., 1, M]); the Eq. 7
integer correction is scale-free, so per-channel dequant broadcasts
s_w[..., 0, :] over the output after the correction.

Expert-batched MVMs (the MoE routed experts)
--------------------------------------------
Weights with a leading expert axis (PackedCodes data [E, K2, M], or
dense codes [E, K, M]) with x_codes [E, C, K] compute, per expert, what
the reference computes under `jax.vmap` over that axis: the caller
(cim_matmul_prequant) quantizes each expert's activations on its own
grid, s_x / zero point [E, 1, 1] and s_w [E, 1, 1] or [E, 1, M]; the
Eq. 7 sums are per expert. The kernel backends register `experts=True`
and run all E experts in one call (the expert-batched entry of B1 / B2 /
B5 / B6); the eager backends (einsum, scan, plain) run one call per
expert.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from repro_torch.kernels import cim_mvm, ops
from repro_torch.runtime.telemetry import KERNEL_COUNTERS

from .adc import adc_quantize
from .energy import mvm_energy
from .macro import MacroConfig, Scheme, SimLevel
from .quant import current_site
from .schemes import cim_mvm_codes, pad_and_group, signed_correction


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
    experts: bool = False         # takes x [E, C, K] x weights [E, ., M]
    einsum_vjp: bool = False      # no autograd: backward is einsum's VJP


_REGISTRY: dict[str, BackendSpec] = {}


def register_backend(name: str, *, schemes, sim_levels, packed=False,
                     experts=False, einsum_vjp=False):
    """Register a backend fn(x_codes, weights, macro, *, key, inl_seed,
    noise_seed) under `name`; `experts`: fn also takes expert-batched
    operands in one call; `einsum_vjp`: fn has no autograd of its own, and
    its gradient is the einsum backend's (`_EinsumVJP`)."""
    def deco(fn):
        _REGISTRY[name] = BackendSpec(name, fn, frozenset(schemes),
                                      frozenset(sim_levels), packed, experts,
                                      einsum_vjp)
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


_ALL_SCHEMES = (Scheme.BP, Scheme.WBS, Scheme.BS)
_ALL_LEVELS = (SimLevel.IDEAL, SimLevel.NOISY, SimLevel.FULL)
_BP, _IDEAL = (Scheme.BP,), (SimLevel.IDEAL,)
_STOCHASTIC = (SimLevel.NOISY, SimLevel.FULL)


# ---------------------------------------------------------------------------
# seeds
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def _seed_tensor(seed: int, device: torch.device) -> torch.Tensor:
    """A 1-element int32 tensor holding `seed` on `device`, made once per
    (seed, device): the kernels read it, so serving steps copy nothing to
    the card and stay capturable in a CUDA graph."""
    return torch.tensor([int(seed)], dtype=torch.int32, device=device)


def _resolve_noise_seed(noise_seed: int | None, key,
                        device) -> torch.Tensor:
    """The int32 seed of the fused stochastic kernels, as a 1-element
    tensor on `device`. Prefers the explicit noise_seed; with only a
    torch.Generator `key` it folds the generator's initial seed to int32,
    so an explicit backend="cuda_noisy" also runs from key-based call
    sites."""
    if noise_seed is not None:
        return _seed_tensor(noise_seed, device)
    if key is not None:
        return _seed_tensor(cim_mvm._wrap_i32(key.initial_seed()), device)
    raise ValueError(
        "the stochastic kernels need CIMConfig.noise_seed (or an explicit "
        "torch.Generator key); at the IDEAL sim level use cuda/cuda_packed")


def _derive_key(noise_seed: int, inl_seed: int,
                device) -> torch.Generator:
    """The eager backends' generator for a noise_seed, seeded with
    salt_seed(noise_seed, inl_seed) as a uint32 (the kernels' salted seed;
    a CPU generator keeps 32 bits of its seed): the counterpart of the
    reference's fold_in(PRNGKey(noise_seed), inl_seed)."""
    salted = cim_mvm.salt_seed(noise_seed, inl_seed)
    g = torch.Generator(device=device)
    g.manual_seed(int(salted) & 0xFFFFFFFF)
    return g


# ---------------------------------------------------------------------------
# eager backends
# ---------------------------------------------------------------------------
def _eager_key(key, noise_seed, inl_seed, x_codes):
    if key is None and noise_seed is not None:
        return _derive_key(noise_seed, inl_seed, x_codes.device)
    return key


@register_backend("einsum", schemes=_ALL_SCHEMES, sim_levels=_ALL_LEVELS)
def _einsum_backend(x_codes, w_codes, cfg: MacroConfig, *, key=None,
                    inl_seed=0, noise_seed=None):
    key = _eager_key(key, noise_seed, inl_seed, x_codes)
    return cim_mvm_codes(x_codes, w_codes, cfg, key=key, inl_seed=inl_seed)


@register_backend("scan", schemes=_ALL_SCHEMES, sim_levels=_ALL_LEVELS)
def _scan_backend(x_codes, w_codes, cfg: MacroConfig, *, key=None,
                  inl_seed=0, noise_seed=None):
    """Group-sequential BP MVM: the math of schemes.bp_mvm with O(M) live
    memory (non-BP schemes go to the einsum path, as in the reference)."""
    if cfg.scheme != Scheme.BP:
        return _einsum_backend(x_codes, w_codes, cfg, key=key,
                               inl_seed=inl_seed, noise_seed=noise_seed)
    key = _eager_key(key, noise_seed, inl_seed, x_codes)
    xg, g = pad_and_group(x_codes.float(), cfg.n_rows)       # [..., G, N]
    wg, _ = pad_and_group(w_codes.float(), cfg.n_rows, axis=0)
    acc = torch.zeros(x_codes.shape[:-1] + (w_codes.shape[-1],),
                      dtype=torch.float32, device=x_codes.device)
    for i in range(g):
        v = xg[..., i, :] @ wg[i]
        acc = acc + adc_quantize(v, cfg, key=key, inl_seed=inl_seed)
    return acc


# ---------------------------------------------------------------------------
# Hopper kernels
# ---------------------------------------------------------------------------
@register_backend("cuda", schemes=_BP, sim_levels=_IDEAL, experts=True, einsum_vjp=True)
def _cuda_backend(x_codes, w_codes, cfg: MacroConfig, **_):
    if w_codes.ndim == 3:
        return ops.cim_mvm_dense_experts(x_codes, w_codes, cfg)
    return ops.cim_mvm_dense(x_codes, w_codes, cfg)


@register_backend("cuda_packed", schemes=_BP, sim_levels=_IDEAL, packed=True,
                  experts=True, einsum_vjp=True)
def _cuda_packed_backend(x_codes, weights: PackedCodes, cfg: MacroConfig,
                         **_):
    if weights.data.ndim == 3:
        return ops.cim_mvm_packed_experts(x_codes, weights.data, cfg)
    return ops.cim_mvm_packed(x_codes, weights.data, cfg)


@register_backend("cuda_noisy", schemes=_BP, sim_levels=_STOCHASTIC,
                  experts=True, einsum_vjp=True)
def _cuda_noisy_backend(x_codes, w_codes, cfg: MacroConfig, *, key=None,
                        inl_seed=0, noise_seed=None):
    seed = _resolve_noise_seed(noise_seed, key, x_codes.device)
    fn = ops.cim_mvm_noisy_experts if w_codes.ndim == 3 \
        else ops.cim_mvm_noisy
    return fn(x_codes, w_codes, cfg, noise_seed=seed, inl_seed=inl_seed)


@register_backend("cuda_noisy_packed", schemes=_BP, sim_levels=_STOCHASTIC,
                  packed=True, experts=True, einsum_vjp=True)
def _cuda_noisy_packed_backend(x_codes, weights: PackedCodes,
                               cfg: MacroConfig, *, key=None, inl_seed=0,
                               noise_seed=None):
    seed = _resolve_noise_seed(noise_seed, key, x_codes.device)
    fn = ops.cim_mvm_noisy_packed_experts if weights.data.ndim == 3 \
        else ops.cim_mvm_noisy_packed
    return fn(x_codes, weights.data, cfg, noise_seed=seed,
              inl_seed=inl_seed)


@register_backend("plain", schemes=_ALL_SCHEMES, sim_levels=_ALL_LEVELS,
                  packed=None, einsum_vjp=True)
def _plain_backend(x_codes, weights, cfg: MacroConfig, *, key=None,
                   inl_seed=0, noise_seed=None):
    """The kernels' plain versions on any device: B1/B2 at IDEAL, B6/B5 at
    NOISY/FULL (same seed contract as cuda_noisy). The WBS/BS baselines
    have no kernel (auto runs them on einsum), so they run on einsum here
    too, as on scan: a manifest's WBS site compares like for like."""
    if cfg.scheme != Scheme.BP:
        w = unpack(weights) if isinstance(weights, PackedCodes) else weights
        return _einsum_backend(x_codes, w, cfg, key=key, inl_seed=inl_seed,
                               noise_seed=noise_seed)
    kw = ops._kernel_kw(cfg)
    packed = isinstance(weights, PackedCodes)
    if packed:
        x2, w2, lead = ops._prep_packed(x_codes, weights.data)
    else:
        x2, w2, lead = ops._prep_dense(x_codes, weights)
    if cfg.sim_level == SimLevel.IDEAL:
        fn = cim_mvm.cim_mvm_grouped_packed_plain if packed \
            else cim_mvm.cim_mvm_grouped_plain
        out = fn(x2, w2, **kw)
    else:
        kw = ops._check_stochastic(cfg)
        fn = cim_mvm.cim_mvm_grouped_noisy_packed_plain if packed \
            else cim_mvm.cim_mvm_grouped_noisy_plain
        out = fn(x2, w2, _resolve_noise_seed(noise_seed, key, x2.device),
                 inl_seed=inl_seed, **kw)
    return out.reshape(*lead, w2.shape[1])


# ---------------------------------------------------------------------------
# gradients of the backends without autograd
# ---------------------------------------------------------------------------
class _EinsumVJP(torch.autograd.Function):
    """Forward: `run(x_codes, w)`, a backend without autograd (a kernel
    launch, or its plain version). Backward: the autograd of the einsum
    backend on the same codes under the same macro config with no key (no
    noise draw; at FULL the INL curve stays, as in the reference's
    `_noisy_mvm_bwd`), per expert for expert-batched operands. `k` is the
    logical depth of nibble-packed stored codes `w` (then w gets no
    gradient), None for dense codes."""

    @staticmethod
    def forward(ctx, x_codes, w, run, macro, inl_seed, k):
        ctx.save_for_backward(x_codes, w)
        ctx.macro, ctx.inl_seed, ctx.k = macro, inl_seed, k
        return run(x_codes, w)

    @staticmethod
    def backward(ctx, g):
        x_codes, w = ctx.saved_tensors
        packed = ctx.k is not None
        w_codes = ops.unpack_codes(w, ctx.k) if packed else w
        want_w = not packed and ctx.needs_input_grad[1]
        with torch.enable_grad():
            xr = x_codes.detach().requires_grad_(ctx.needs_input_grad[0])
            wr = w_codes.detach().requires_grad_(want_w)

            def einsum(xe, we):
                return _einsum_backend(xe, we, ctx.macro,
                                       inl_seed=ctx.inl_seed)

            y = torch.stack([einsum(xr[e], wr[e])
                             for e in range(wr.shape[0])]) \
                if wr.ndim == 3 else einsum(xr, wr)
            inputs = [t for t in (xr, wr) if t.requires_grad]
            grads = iter(torch.autograd.grad(y, inputs, g))
        gx = next(grads) if xr.requires_grad else None
        gw = next(grads) if want_w else None
        return gx, gw, None, None, None, None


def _needs_grad(x_codes: torch.Tensor, w: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (x_codes.requires_grad
                                        or w.requires_grad)


# ---------------------------------------------------------------------------
# backend selection
# ---------------------------------------------------------------------------
# Materializing the [rows, G, M] pre-ADC tensor beyond this switches the
# eager path from einsum to the group-sequential scan.
_EINSUM_BYTES_CEILING = 64 << 20


def choose_backend(cfg, x_codes: torch.Tensor, weights) -> str:
    """Resolve cfg.backend ("auto" or explicit) to a registered backend:

      * IDEAL + BP → the Hopper kernel for the container, "cuda_packed"
        for PackedCodes, else "cuda";
      * NOISY/FULL + BP with a noise_seed → "cuda_noisy[_packed]";
      * otherwise (no seed, WBS/BS) → "einsum", or "scan" for BP once the
        pre-ADC tensor would exceed 64 MB.
    """
    macro: MacroConfig = cfg.macro
    packed = isinstance(weights, PackedCodes)
    if cfg.backend != "auto":
        return get_backend(cfg.backend).name
    if macro.scheme == Scheme.BP:
        if macro.sim_level == SimLevel.IDEAL:
            return "cuda_packed" if packed else "cuda"
        if getattr(cfg, "noise_seed", None) is not None:
            return "cuda_noisy_packed" if packed else "cuda_noisy"
    k = weights.k if packed else weights.shape[-2]
    m = weights.n_cols if packed else weights.shape[-1]
    groups = -(-k // macro.n_rows)
    rows = math.prod(x_codes.shape[:-1]) if x_codes.ndim > 1 else 1
    big = rows * groups * m * 4 > _EINSUM_BYTES_CEILING
    return "scan" if (big and macro.scheme == Scheme.BP) else "einsum"


_ENERGY_CACHE: dict = {}    # (macro, k) -> e_mvm_j, see _record_dispatch


def _record_dispatch(name: str, x_codes: torch.Tensor, weights,
                     macro: MacroConfig) -> None:
    """Observability hook: count the backend pick and accumulate the
    paper-model CIM energy of this MVM under the active `act_site` name.

    Runs on every call (the port is eager), so KERNEL_COUNTERS counts
    calls; see telemetry.KernelCounters. Energy is Eq. 4 per K-deep dot
    product (energy.mvm_energy, cached per (macro, K)) times the call's
    dot count (rows x output columns). Reads shapes only: no tensor value
    reaches the host. An expert-batched call counts one dispatch and all
    E·C rows; the reference's trace-time hook sees one vmap slice (C
    rows), once per compiled shape."""
    if isinstance(weights, PackedCodes):
        k, m = weights.k, weights.data.shape[-1]
    else:
        k, m = weights.shape[-2], weights.shape[-1]
    rows = math.prod(x_codes.shape[:-1])
    key = (macro, k)
    e_dot = _ENERGY_CACHE.get(key)
    if e_dot is None:
        e_dot = _ENERGY_CACHE[key] = mvm_energy(macro, k).e_mvm_j
    KERNEL_COUNTERS.count_backend(name)
    KERNEL_COUNTERS.add_site_energy(current_site() or "<unsited>",
                                    e_dot * rows * m, rows * m)


def _expert_count(weights) -> int:
    """E for expert-batched weights ([E, K2, M] packed, [E, K, M] dense),
    0 for a single matrix."""
    data = weights.data if isinstance(weights, PackedCodes) else weights
    return data.shape[0] if data.ndim == 3 else 0


def _per_expert(spec: BackendSpec, x_codes, weights, macro, kw):
    """A backend without an expert-batched entry, one call per expert (as
    the reference's vmap computes each slice); [E, C, M]."""
    outs = []
    for e in range(x_codes.shape[0]):
        w_e = PackedCodes(weights.data[e], weights.k) \
            if isinstance(weights, PackedCodes) else weights[e]
        outs.append(spec.fn(x_codes[e], w_e, macro, **kw))
    return torch.stack(outs)


def execute_mvm(x_codes: torch.Tensor, weights, cfg, *, s_x: torch.Tensor,
                s_w: torch.Tensor | None, x_zero_point: torch.Tensor,
                key: torch.Generator | None = None, inl_seed: int = 0,
                backend: str | None = None,
                noise_seed: int | None = None) -> torch.Tensor:
    """Run one MVM through the simulated datapath and dequantize.

    x_codes [..., K] unsigned DAC codes; weights are dense stored codes
    [K, M] (float / int8 container) or PackedCodes. Eq. 7's ΣW̃ comes from
    the packed bytes and `k` is the logical K. Expert-batched weights
    ([E, ., M], x_codes [E, C, K]) run per expert (module docstring).
    `noise_seed` overrides cfg.noise_seed for this call; `key` is a
    torch.Generator for the eager backends (see the module docstring).
    Returns f32 [..., M].
    """
    macro: MacroConfig = cfg.macro
    if noise_seed is None:
        noise_seed = getattr(cfg, "noise_seed", None)
    if macro.sim_level == SimLevel.IDEAL:
        key = None          # no stochastic terms at the ideal sim level
        noise_seed = None
    name = backend or choose_backend(cfg, x_codes, weights)
    _record_dispatch(name, x_codes, weights, macro)
    spec = get_backend(name)
    if macro.scheme not in spec.schemes:
        raise ValueError(f"backend {name!r} does not implement scheme "
                         f"{macro.scheme}; use einsum/scan")
    if macro.sim_level not in spec.sim_levels:
        if SimLevel.IDEAL in spec.sim_levels:
            raise ValueError(
                f"backend {name!r} is deterministic; sim level "
                f"{macro.sim_level} needs a stochastic backend "
                "(einsum/scan/cuda_noisy)")
        raise ValueError(
            f"backend {name!r} models the stochastic converter chain only; "
            f"sim level {macro.sim_level} runs on cuda/cuda_packed or the "
            "eager backends")
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
    kw = dict(key=key, inl_seed=inl_seed, noise_seed=noise_seed)
    experts = _expert_count(weights)
    if not packed:
        weights = weights.to(torch.float32)
    data = weights.data if packed else weights

    def run(xc, wd):
        wt = PackedCodes(wd, weights.k) if packed else wd
        if experts and not spec.experts:
            return _per_expert(spec, xc, wt, macro, kw)
        return spec.fn(xc, wt, macro, **kw)

    if spec.einsum_vjp and _needs_grad(x_codes, data):
        y_codes = _EinsumVJP.apply(x_codes, data, run, macro, inl_seed,
                                   weights.k if packed else None)
    else:
        y_codes = run(x_codes, data)
    if packed:
        sum_w = ops.packed_col_sums(weights.data)
        k = weights.k
    else:
        sum_w = torch.sum(weights, dim=-2)
        k = weights.shape[-2]
    if experts:                    # [E, M] → [E, 1, M] against [E, C, M]
        sum_w = sum_w.unsqueeze(-2)
    y_int = signed_correction(y_codes, x_codes, None,
                              w_offset=cfg.weight.offset,
                              x_zero_point=x_zero_point, sum_w=sum_w, k=k)
    s_w_out = s_w
    if cfg.weight.per_channel and s_w.ndim >= 2 and not experts:
        s_w_out = s_w[..., 0, :]
    return y_int * s_x * s_w_out
