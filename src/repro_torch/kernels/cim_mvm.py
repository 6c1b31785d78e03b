"""Grouped ADC MVM: kernels B1 (nibble-packed weights) and B2 (dense codes).

    y[M, N] = Σ_g lsb · clip(round(inv_lsb · Σ_{r<144} x[m, 144g+r] · w[144g+r, n]), 0, L−1)

x holds f32 DAC codes 0..15 and w stored codes 0..15: dense f32 [K, N] for
B2, or nibble-packed uint8 [ceil(K/2), N] for B1 (row 2i in the low nibble,
2i+1 in the high). K pads with zero codes to a multiple of the macro depth
(zero codes are unselected SRAM rows, exact no-ops). lsb = full_scale /
(gain·(L−1)) and inv_lsb = 1/lsb are computed in float64 and rounded to f32
once, as the TPU kernels receive them; round is half-to-even; groups add to
the output in ascending order, each as one fused multiply-add
o = fma(code, lsb, o) with a single rounding. That is how the reference
Pallas kernel's `o += code * lsb` evaluates when it runs under XLA on the
CPU (interpret mode): a multiply-then-add differs from it in the last bit.

Each function has a plain PyTorch version here (`*_plain`) and a wrapper
that launches the Hopper kernel in `csrc/cim_mvm.cu` on a CUDA tensor and
runs the plain version on a CPU tensor. The wrappers count their launches
(`<wrapper>.launches`).
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch
import torch.nn.functional as F

from . import build


def _f32(v: float) -> float:
    return struct.unpack("f", struct.pack("f", v))[0]


@functools.lru_cache(maxsize=64)
def adc_constants(levels: int, gain: float,
                  full_scale: float) -> tuple[float, float]:
    """(lsb, inv_lsb) as the f32 values the kernels use: computed in
    float64, rounded to f32 once."""
    lsb = full_scale / (gain * (levels - 1))
    return _f32(lsb), _f32(1.0 / lsb)


def _pad_rows(t: torch.Tensor, multiple: int, dim: int) -> torch.Tensor:
    pad = (-t.shape[dim]) % multiple
    if not pad:
        return t
    widths = [0, 0] * (t.ndim - dim % t.ndim - 1) + [0, pad]
    return F.pad(t, widths)


def unpack_nibbles(w_packed: torch.Tensor) -> torch.Tensor:
    """[K2, N] uint8 nibble pairs → [2·K2, N] f32 codes (row 2i low nibble,
    2i+1 high)."""
    wi = w_packed.to(torch.int32)
    lo = (wi & 15).float()
    hi = ((wi >> 4) & 15).float()
    k2, n = w_packed.shape[-2:]
    return torch.stack([lo, hi], dim=-2).reshape(*w_packed.shape[:-2],
                                                 2 * k2, n)


def _grouped_adc(xp: torch.Tensor, wp: torch.Tensor, n_rows: int,
                 levels: int, gain: float, full_scale: float) -> torch.Tensor:
    """Per-group MAC, ADC transfer and ascending digital accumulation over
    padded operands xp [M, Kp] and wp [Kp, N] (f32 codes)."""
    lsb, inv_lsb = adc_constants(levels, gain, full_scale)
    out = torch.zeros(xp.shape[0], wp.shape[1], dtype=torch.float32,
                      device=xp.device)
    for g in range(xp.shape[1] // n_rows):
        rows = slice(g * n_rows, (g + 1) * n_rows)
        part = xp[:, rows] @ wp[rows]            # exact: integers < 2^24
        # inv_lsb is an f32 value, so the f32 product is the kernel's
        code = torch.clamp(torch.round(part * inv_lsb), 0.0,
                           float(levels - 1))
        # fma(code, lsb, out): in float64 the product (9 x 24 bits) and the
        # sum are exact, so the one rounding back to f32 is the FMA's
        out = (out.double() + code.double() * lsb).float()
    return out


def cim_mvm_grouped_plain(x: torch.Tensor, w: torch.Tensor, *, n_rows: int,
                          levels: int, gain: float,
                          full_scale: float) -> torch.Tensor:
    """Plain version of B2: x [M, K] f32 codes, w [K, N] codes."""
    xp = _pad_rows(x.float(), n_rows, 1)
    wp = _pad_rows(w.float(), n_rows, 0)
    return _grouped_adc(xp, wp, n_rows, levels, gain, full_scale)


def cim_mvm_grouped_packed_plain(x: torch.Tensor, w_packed: torch.Tensor, *,
                                 n_rows: int, levels: int, gain: float,
                                 full_scale: float) -> torch.Tensor:
    """Plain version of B1: x [M, K] f32 codes, w_packed [K2, N] uint8 with
    K ≤ 2·K2. x pads to the byte rows first, then both pad to the macro
    depth (zero bytes are two unselected rows)."""
    xp = _pad_rows(_pad_rows(x.float(), 2, 1), n_rows, 1)
    wp = unpack_nibbles(_pad_rows(w_packed, n_rows // 2, 0))
    return _grouped_adc(xp, wp, n_rows, levels, gain, full_scale)


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _check_mvm_operands(x: torch.Tensor, w: torch.Tensor, wdtype,
                        n_rows: int) -> None:
    if not w.is_cuda or w.device != x.device:
        raise ValueError("x and w must lie on the same CUDA device")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 2-D float32 tensor")
    if w.dtype != wdtype or w.ndim != 2 or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous 2-D {wdtype} tensor")
    if n_rows % 2 or n_rows > 512:
        raise ValueError(f"n_rows={n_rows} unsupported by the kernel "
                         "(even and at most 512)")


def cim_mvm_grouped(x: torch.Tensor, w: torch.Tensor, *, n_rows: int,
                    levels: int, gain: float,
                    full_scale: float) -> torch.Tensor:
    """B2: grouped ADC MVM over dense codes, x [M, K] f32 × w [K, N] f32 →
    [M, N] f32. Replaces `kernels/cim_mvm.py:cim_mvm_grouped` of the JAX
    package."""
    kw = dict(n_rows=n_rows, levels=levels, gain=gain, full_scale=full_scale)
    if not x.is_cuda:
        return cim_mvm_grouped_plain(x, w, **kw)
    _check_mvm_operands(x, w, torch.float32, n_rows)
    m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"shape mismatch x {tuple(x.shape)} w "
                         f"{tuple(w.shape)}")
    n = w.shape[1]
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    lsb, inv_lsb = adc_constants(levels, gain, full_scale)
    lib = build.load("cim_mvm")
    rc = lib.cim_mvm_dense_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, n_rows,
        inv_lsb, lsb, float(levels - 1),
        torch.cuda.current_stream(x.device).cuda_stream)
    cim_mvm_grouped.launches += 1
    _check_launch("cim_mvm_grouped", rc)
    return out


def cim_mvm_grouped_packed(x: torch.Tensor, w_packed: torch.Tensor, *,
                           n_rows: int, levels: int, gain: float,
                           full_scale: float) -> torch.Tensor:
    """B1: grouped ADC MVM over nibble-packed codes, x [M, K] f32 × w
    [K2, N] uint8 (K ≤ 2·K2) → [M, N] f32. Replaces
    `kernels/cim_mvm.py:cim_mvm_grouped_packed` of the JAX package."""
    kw = dict(n_rows=n_rows, levels=levels, gain=gain, full_scale=full_scale)
    if not x.is_cuda:
        return cim_mvm_grouped_packed_plain(x, w_packed, **kw)
    _check_mvm_operands(x, w_packed, torch.uint8, n_rows)
    m, k = x.shape
    k2, n = w_packed.shape
    if k not in (2 * k2, 2 * k2 - 1):
        raise ValueError(f"shape mismatch x {tuple(x.shape)} w_packed "
                         f"{tuple(w_packed.shape)}")
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    lsb, inv_lsb = adc_constants(levels, gain, full_scale)
    lib = build.load("cim_mvm")
    rc = lib.cim_mvm_packed_launch(
        x.data_ptr(), w_packed.data_ptr(), out.data_ptr(), m, n, k, k2,
        n_rows, inv_lsb, lsb, float(levels - 1),
        torch.cuda.current_stream(x.device).cuda_stream)
    cim_mvm_grouped_packed.launches += 1
    _check_launch("cim_mvm_grouped_packed", rc)
    return out


cim_mvm_grouped.launches = 0
cim_mvm_grouped_packed.launches = 0

# ctypes signatures of the C entry points in csrc/cim_mvm.cu
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
build.declare("cim_mvm", {
    "cim_mvm_dense_launch": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P],
    "cim_mvm_packed_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F,
                              _P],
})
