"""Entry points of the grouped ADC MVM kernels and the nibble-pack helpers.

Handles leading-dim flattening and operand dtype/contiguity, then calls
the kernel wrappers in `kernels.cim_mvm` (B1 packed, B2 dense, their
stochastic twins B6, B5, and each one's expert-batched entry). K is not
padded here: the plain versions zero-pad it to the macro depth, and the
CUDA kernels read rows past K as zero codes, which is the same function
without copying the weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.adc import stochastic_transfer_params
from repro_torch.core.macro import MacroConfig, Scheme, SimLevel

from . import autotune

from .cim_mvm import (cim_mvm_grouped, cim_mvm_grouped_experts,
                      cim_mvm_grouped_noisy, cim_mvm_grouped_noisy_experts,
                      cim_mvm_grouped_noisy_packed,
                      cim_mvm_grouped_noisy_packed_experts,
                      cim_mvm_grouped_packed, cim_mvm_grouped_packed_experts,
                      salt_seed, unpack_nibbles)

__all__ = ["cim_mvm_dense", "cim_mvm_packed", "cim_mvm_noisy",
           "cim_mvm_noisy_packed", "cim_mvm_dense_experts",
           "cim_mvm_packed_experts", "cim_mvm_noisy_experts",
           "cim_mvm_noisy_packed_experts", "pack_codes", "unpack_codes",
           "packed_col_sums", "salt_seed"]


def pack_codes(w_codes: torch.Tensor) -> torch.Tensor:
    """[..., K, N] 4-bit codes → [..., ceil(K/2), N] uint8 nibble pairs.

    Row 2i lands in the low nibble, row 2i+1 in the high nibble. Odd K is
    zero-padded first (a zero code is an unselected SRAM row — an exact
    no-op in the MVM and in the Eq. 7 correction sums).
    """
    k, n = w_codes.shape[-2:]
    if k % 2:
        w_codes = F.pad(w_codes, (0, 0, 0, 1))
        k += 1
    wi = w_codes.to(torch.int32).reshape(*w_codes.shape[:-2], k // 2, 2, n)
    return (wi[..., 0, :] | (wi[..., 1, :] << 4)).to(torch.uint8)


def unpack_codes(w_packed: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """Inverse of pack_codes: [..., K2, N] uint8 → [..., K, N] f32 codes;
    `k` trims the pack-padding row when the logical K was odd."""
    full = unpack_nibbles(w_packed)
    return full if k is None else full[..., :k, :]


def packed_col_sums(w_packed: torch.Tensor) -> torch.Tensor:
    """Σ_K W̃ per output column straight from the packed bytes — the Eq. 7
    ΣW̃ correction term without unpacking (pad rows are zero codes)."""
    wi = w_packed.to(torch.int32)
    return torch.sum((wi & 15) + ((wi >> 4) & 15), dim=-2).to(torch.float32)


def _prep_dense(x_codes: torch.Tensor, w_codes: torch.Tensor):
    """Operand prep for the dense kernel: flatten leading dims; f32,
    contiguous. Returns (x2, w2, lead)."""
    lead = x_codes.shape[:-1]
    x2 = x_codes.reshape(-1, x_codes.shape[-1]).to(torch.float32).contiguous()
    return x2, w_codes.to(torch.float32).contiguous(), lead


def _prep_packed(x_codes: torch.Tensor, w_packed: torch.Tensor):
    """Packed twin of _prep_dense: K must be 2·K2 or 2·K2 − 1."""
    k = x_codes.shape[-1]
    k2 = w_packed.shape[0]
    if k not in (2 * k2, 2 * k2 - 1):
        raise ValueError(f"x {tuple(x_codes.shape)} does not match packed "
                         f"w {tuple(w_packed.shape)}")
    lead = x_codes.shape[:-1]
    x2 = x_codes.reshape(-1, k).to(torch.float32).contiguous()
    return x2, w_packed.to(torch.uint8).contiguous(), lead


def _prep_experts(x_codes: torch.Tensor, w_packed: torch.Tensor):
    """Operand prep of the expert-batched packed kernels: x [E, C, K] f32,
    w [E, K2, M] uint8, both contiguous."""
    if x_codes.ndim != 3 or w_packed.ndim != 3 \
            or x_codes.shape[0] != w_packed.shape[0] \
            or x_codes.shape[-1] not in (2 * w_packed.shape[1],
                                         2 * w_packed.shape[1] - 1):
        raise ValueError(f"x {tuple(x_codes.shape)} does not match packed "
                         f"expert weights {tuple(w_packed.shape)}")
    return (x_codes.to(torch.float32).contiguous(),
            w_packed.to(torch.uint8).contiguous())


def _prep_dense_experts(x_codes: torch.Tensor, w_codes: torch.Tensor):
    """Operand prep of the expert-batched dense kernels: x [E, C, K] f32,
    w [E, K, M] f32 codes, both contiguous."""
    if x_codes.ndim != 3 or w_codes.ndim != 3 \
            or x_codes.shape[0] != w_codes.shape[0] \
            or x_codes.shape[-1] != w_codes.shape[1]:
        raise ValueError(f"x {tuple(x_codes.shape)} does not match expert "
                         f"weights {tuple(w_codes.shape)}")
    return (x_codes.to(torch.float32).contiguous(),
            w_codes.to(torch.float32).contiguous())


_NO_KNOBS = {"cluster": 0, "wcols": 0}


def _resolve_knobs(backend: str, x: torch.Tensor, n: int, cfg: MacroConfig,
                   cluster: int | None, wcols: int | None) -> dict:
    """The launch knobs of one MVM: explicit values win; None consults the
    tuning cache under "cim_mvm" and the shape family of x's rows (the
    row count of one expert for expert-batched x), K's group count and N
    (how core.engine's kernel backends, which pass no knobs, pick up a
    tuned launch); a miss keeps 0, the launcher's choice. The values go
    to the launcher as they are: it clamps what the geometry cannot take,
    and the wrapper counts each such launch once (`cim_mvm._count_clamp`).
    """
    if (cluster is None or wcols is None) and autotune.cache_path():
        k = x.shape[-1]
        m = x.shape[1] if backend.endswith("_experts") \
            else x.numel() // max(k, 1)
        entry = autotune.tuned(
            "cim_mvm", autotune.mvm_family(m, max(1, -(-k // cfg.n_rows)),
                                           n), backend, x.device)
        cluster = entry.get("cluster", 0) if cluster is None else cluster
        wcols = entry.get("wcols", 0) if wcols is None else wcols
    cluster, wcols = int(cluster or 0), int(wcols or 0)
    return dict(cluster=cluster, wcols=wcols) if cluster or wcols \
        else _NO_KNOBS


def _code_bits(cfg: MacroConfig) -> int:
    """The codes' width as the expert-batched dense kernels take it: the
    wider of the DAC and stored code widths (their tensor-core body holds
    codes of at most 8 bits)."""
    return max(cfg.act_bits, cfg.weight_bits)


def _kernel_kw(cfg: MacroConfig) -> dict:
    return dict(n_rows=cfg.n_rows, levels=cfg.effective_adc_levels(),
                gain=cfg.gain, full_scale=cfg.full_scale())


def cim_mvm_packed(x_codes: torch.Tensor, w_packed: torch.Tensor,
                   cfg: MacroConfig, *, cluster: int | None = None,
                   wcols: int | None = None) -> torch.Tensor:
    """ŷ ≈ Σ X̃ W̃ with 4-bit-packed weights: x [..., K], w_packed [K2, M]
    (K ≤ 2·K2) → f32 [..., M], through kernel B1."""
    if cfg.scheme != Scheme.BP or cfg.n_rows % 2:
        raise ValueError("the packed kernel implements BP over an even "
                         "macro depth")
    knobs = _resolve_knobs("cuda_packed", x_codes, w_packed.shape[-1], cfg,
                           cluster, wcols)
    x2, w2, lead = _prep_packed(x_codes, w_packed)
    out = cim_mvm_grouped_packed(x2, w2, **_kernel_kw(cfg), **knobs)
    return out.reshape(*lead, w2.shape[1])


def cim_mvm_packed_experts(x_codes: torch.Tensor, w_packed: torch.Tensor,
                           cfg: MacroConfig, *, cluster: int | None = None,
                           wcols: int | None = None) -> torch.Tensor:
    """B1 over E experts in one launch: x [E, C, K], w_packed [E, K2, M] →
    f32 [E, C, M], expert e exactly `cim_mvm_packed(x[e], w_packed[e])`."""
    if cfg.scheme != Scheme.BP or cfg.n_rows % 2:
        raise ValueError("the packed kernel implements BP over an even "
                         "macro depth")
    x3, w3 = _prep_experts(x_codes, w_packed)
    knobs = _resolve_knobs("cuda_packed_experts", x3, w3.shape[-1], cfg,
                           cluster, wcols)
    return cim_mvm_grouped_packed_experts(x3, w3, **_kernel_kw(cfg), **knobs)


def cim_mvm_dense(x_codes: torch.Tensor, w_codes: torch.Tensor,
                  cfg: MacroConfig, *, cluster: int | None = None,
                  wcols: int | None = None) -> torch.Tensor:
    """ŷ ≈ Σ X̃ W̃ through the fused BP kernel B2: x [..., K] DAC codes,
    w [K, M] stored codes → f32 [..., M]."""
    if cfg.scheme != Scheme.BP:
        raise ValueError("the fused kernel implements BP only")
    knobs = _resolve_knobs("cuda", x_codes, w_codes.shape[-1], cfg, cluster,
                           wcols)
    x2, w2, lead = _prep_dense(x_codes, w_codes)
    out = cim_mvm_grouped(x2, w2, **_kernel_kw(cfg), **knobs)
    return out.reshape(*lead, w2.shape[1])


def cim_mvm_dense_experts(x_codes: torch.Tensor, w_codes: torch.Tensor,
                          cfg: MacroConfig, *, cluster: int | None = None,
                          wcols: int | None = None) -> torch.Tensor:
    """B2 over E experts in one launch: x [E, C, K], w [E, K, M] stored
    codes → f32 [E, C, M], expert e exactly `cim_mvm_dense(x[e],
    w_codes[e])`."""
    if cfg.scheme != Scheme.BP:
        raise ValueError("the fused kernel implements BP only")
    x3, w3 = _prep_dense_experts(x_codes, w_codes)
    knobs = _resolve_knobs("cuda_experts", x3, w3.shape[-1], cfg, cluster,
                           wcols)
    return cim_mvm_grouped_experts(x3, w3, **_kernel_kw(cfg), **knobs,
                                   code_bits=_code_bits(cfg))


def _check_stochastic(cfg: MacroConfig) -> dict:
    if cfg.scheme != Scheme.BP:
        raise ValueError("the fused stochastic kernels implement BP only")
    if cfg.sim_level == SimLevel.IDEAL:
        raise ValueError("the IDEAL transfer runs the deterministic kernels "
                         "(cim_mvm_dense / cim_mvm_packed)")
    st = stochastic_transfer_params(cfg)
    return dict(_kernel_kw(cfg), sigma=st["sigma"], inl_amp=st["inl_amp"],
                apply_inl=st["apply_inl"])


def cim_mvm_noisy(x_codes: torch.Tensor, w_codes: torch.Tensor,
                  cfg: MacroConfig, *, noise_seed: torch.Tensor,
                  inl_seed: int = 0, cluster: int | None = None,
                  wcols: int | None = None) -> torch.Tensor:
    """Stochastic (NOISY/FULL) fused BP MVM through kernel B5: per-conversion
    thermal noise (and, at FULL, the Fig. 15 INL instance of inl_seed) drawn
    inside the kernel. `noise_seed` is an int32 scalar tensor on x's device
    (a CPU tensor or an int on the CPU); σ/INL come from
    core.adc.stochastic_transfer_params, as adc_quantize takes them."""
    kw = _check_stochastic(cfg)
    knobs = _resolve_knobs("cuda_noisy", x_codes, w_codes.shape[-1], cfg,
                           cluster, wcols)
    x2, w2, lead = _prep_dense(x_codes, w_codes)
    out = cim_mvm_grouped_noisy(x2, w2, noise_seed, inl_seed=inl_seed, **kw,
                                **knobs)
    return out.reshape(*lead, w2.shape[1])


def cim_mvm_noisy_experts(x_codes: torch.Tensor, w_codes: torch.Tensor,
                          cfg: MacroConfig, *, noise_seed: torch.Tensor,
                          inl_seed: int = 0, cluster: int | None = None,
                          wcols: int | None = None) -> torch.Tensor:
    """B5 over E experts in one launch: x [E, C, K], w [E, K, M] → f32
    [E, C, M], expert e exactly `cim_mvm_noisy(x[e], w_codes[e])` under the
    same seed."""
    kw = _check_stochastic(cfg)
    x3, w3 = _prep_dense_experts(x_codes, w_codes)
    knobs = _resolve_knobs("cuda_noisy_experts", x3, w3.shape[-1], cfg,
                           cluster, wcols)
    return cim_mvm_grouped_noisy_experts(x3, w3, noise_seed,
                                         inl_seed=inl_seed, **kw, **knobs,
                                         code_bits=_code_bits(cfg))


def cim_mvm_noisy_packed(x_codes: torch.Tensor, w_packed: torch.Tensor,
                         cfg: MacroConfig, *, noise_seed: torch.Tensor,
                         inl_seed: int = 0, cluster: int | None = None,
                         wcols: int | None = None) -> torch.Tensor:
    """Stochastic fused BP MVM over nibble-packed weights (kernel B6):
    bit-identical to cim_mvm_noisy on the unpacked codes under one seed."""
    kw = _check_stochastic(cfg)
    if cfg.n_rows % 2:
        raise ValueError("nibble packing needs an even macro depth")
    knobs = _resolve_knobs("cuda_noisy_packed", x_codes, w_packed.shape[-1],
                           cfg, cluster, wcols)
    x2, w2, lead = _prep_packed(x_codes, w_packed)
    out = cim_mvm_grouped_noisy_packed(x2, w2, noise_seed, inl_seed=inl_seed,
                                       **kw, **knobs)
    return out.reshape(*lead, w2.shape[1])


def cim_mvm_noisy_packed_experts(x_codes: torch.Tensor,
                                 w_packed: torch.Tensor, cfg: MacroConfig, *,
                                 noise_seed: torch.Tensor, inl_seed: int = 0,
                                 cluster: int | None = None,
                                 wcols: int | None = None) -> torch.Tensor:
    """B6 over E experts in one launch: x [E, C, K], w_packed [E, K2, M] →
    f32 [E, C, M], expert e exactly `cim_mvm_noisy_packed(x[e],
    w_packed[e])` under the same seed."""
    kw = _check_stochastic(cfg)
    if cfg.n_rows % 2:
        raise ValueError("nibble packing needs an even macro depth")
    x3, w3 = _prep_experts(x_codes, w_packed)
    knobs = _resolve_knobs("cuda_noisy_packed_experts", x3, w3.shape[-1],
                           cfg, cluster, wcols)
    return cim_mvm_grouped_noisy_packed_experts(x3, w3, noise_seed,
                                                inl_seed=inl_seed, **kw,
                                                **knobs)
