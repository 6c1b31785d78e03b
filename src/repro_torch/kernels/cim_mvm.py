"""Grouped ADC MVM: kernels B1/B2 (IDEAL transfer) and B5/B6 (NOISY/FULL).

    y[M, N] = Σ_g lsb · clip(round(T(Σ_{r<R} x[m, Rg+r] · w[Rg+r, n])), 0, L−1)

with R = n_rows rows per macro group (144 by default).
x holds f32 DAC codes 0..15 and w stored codes 0..15: dense f32 [K, N] for
B2/B5, or nibble-packed uint8 [ceil(K/2), N] for B1/B6 (row 2i in the low
nibble, 2i+1 in the high). K pads with zero codes to a multiple of the
macro depth (zero codes are unselected SRAM rows, exact no-ops). lsb =
full_scale / (gain·(L−1)) and inv_lsb = 1/lsb are computed in float64 and
rounded to f32 once, as the TPU kernels receive them; round is
half-to-even; groups add to the output in ascending order, each as one
fused multiply-add o = fma(code, lsb, o) with a single rounding. That is
how the reference Pallas kernel's `o += code * lsb` evaluates when it runs
under XLA on the CPU (interpret mode): a multiply-then-add differs from it
in the last bit.

The transfer T is part · inv_lsb at IDEAL. The stochastic kernels add, per
conversion and in this order (the reference's `_stochastic_transfer`):
  * at FULL, the INL instance of `inl_seed`: x = fma(part, inv_lsb,
    inl_curve(clip(part · (inv_lsb / L), 0, 1))), the constants folded as
    XLA folds them;
  * thermal noise x = fma(σ, N(0,1), x), with N(0,1) the Irwin–Hall sum of
    12 uniforms from a murmur3-finalizer hash of (salt_seed(seed,
    inl_seed), GLOBAL row, GLOBAL column, group). The draw depends on
    neither the tiling nor the weight container, so B6 equals B5 bit for
    bit. XLA contracts both additions into fused multiply-adds when it
    runs the reference kernel; the kernels use fmaf and the plain versions
    `core.adc.fma_f32`.
The plain versions compute the uint32 hash in int64 masked to 32 bits
(torch has no `>>` on uint32 on the CPU) and take the low 32 bits of each
product through a 16-bit split, so no int64 product overflows.

Each function has a plain PyTorch version here (`*_plain`) and a wrapper
that launches the Hopper kernel in `csrc/cim_mvm.cu` on a CUDA tensor and
runs the plain version on a CPU tensor. Each kernel also has an
expert-batched entry (`*_experts`: x [E, M, K], w [E, K2, N] or dense
[E, K, N] in one launch, for the MoE routed experts), each expert
bit-identical to the 2-D kernel on its own operands. The wrappers count their launches
(`<wrapper>.launches`). The macro depth n_rows may be any depth >= 1 for
the dense kernels B2/B5, as in the reference; the packed B1/B6 need an
even depth (the reference's packed kernels assert it) of at most
PACKED_MAX_ROWS (`check_depth`).
"""
from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.adc import fma_f32, inl_curve, inl_instance

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


_M32 = 0xFFFFFFFF
_GOLDEN32 = 0x9E3779B9        # 2^32/φ, the SplitMix increment


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of h·c for h in [0, 2^32) (int64) and a uint32 constant
    c, through a 16-bit split of c so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _wrap_i32(v: int) -> int:
    v &= _M32
    return v - (1 << 32) if v >= 0x80000000 else v


def salt_term(salt: int) -> int:
    """What `salt_seed` XORs into a seed for `salt`, as a uint32: the int32
    product salt·(−1640531527), wrapped. Salt 0 gives 0 (the identity)."""
    return (_wrap_i32(int(salt)) * -1640531527) & _M32


def salt_seed(seed, salt: int) -> torch.Tensor:
    """Fold a decorrelation salt into an int32 kernel seed: seed XOR the
    golden-ratio-scrambled salt, with int32 wrap-around (salt 0 is the
    identity). `seed` is a Python int or an int32 tensor."""
    v = (torch.as_tensor(seed).to(torch.int64) & _M32) ^ salt_term(salt)
    return (v - ((v >> 31) << 32)).to(torch.int32)


def _counter_base(seed: torch.Tensor, rows, cols, group) -> torch.Tensor:
    """Per-conversion uint32 hash state (int64) from the salted seed (a
    uint32 value) and the global row, column and group, each absorbed
    through one _mix32."""
    h = _mix32(seed ^ _GOLDEN32)
    h = _mix32(h ^ rows)
    h = _mix32(h ^ cols)
    return _mix32(h ^ ((group * 0x01000193) & _M32))


def _normal12(base: torch.Tensor) -> torch.Tensor:
    """N(0,1) per element: the Irwin–Hall sum of 12 uniforms, draw j being
    mix32(base + j·GOLDEN) converted to f32 and added in order j = 1..12."""
    acc = torch.zeros(base.shape, dtype=torch.float32, device=base.device)
    for j in range(1, 13):
        acc = acc + _mix32((base + ((j * _GOLDEN32) & _M32)) & _M32).float()
    return acc * 2.0 ** -32 - 6.0


def _frac_scale(inv_lsb: float, levels: int) -> float:
    """The f32 constant inv_lsb / L. The reference writes the INL curve's
    code fraction as (part · inv_lsb) / L; XLA folds the two constants and
    evaluates part · (inv_lsb / L) (the division as written differs from
    the reference in 7 of 65,536 outputs, tests/test_torch_noisy.py)."""
    return float(np.float32(inv_lsb) / np.float32(levels))


def _noisy_transfer(seed: torch.Tensor, *, levels: int, sigma: float,
                    inl_amp: float, inl_seed: int, apply_inl: bool):
    """The stochastic transfer as a function (parts [G, M, N], inv_lsb) → x
    in LSB units, pre-rounding (see the module docstring)."""
    def transfer(parts, inv_lsb):
        g, m, n = parts.shape
        dev = parts.device
        if apply_inl:
            frac = torch.clamp(parts * _frac_scale(inv_lsb, levels), 0.0, 1.0)
            x = fma_f32(parts, inv_lsb, inl_curve(frac, inl_amp, inl_seed))
        else:
            x = parts * inv_lsb
        salted = (torch.as_tensor(seed, device=dev).reshape(()).to(
            torch.int64) & _M32) ^ salt_term(inl_seed)
        base = _counter_base(
            salted, torch.arange(m, device=dev).view(1, m, 1),
            torch.arange(n, device=dev).view(1, 1, n),
            torch.arange(g, device=dev).view(g, 1, 1))
        return fma_f32(_f32(sigma), _normal12(base), x)
    return transfer


def _grouped_adc(xp: torch.Tensor, wp: torch.Tensor, n_rows: int,
                 levels: int, gain: float, full_scale: float,
                 transfer=None) -> torch.Tensor:
    """Per-group MAC, ADC transfer and ascending digital accumulation over
    padded operands xp [M, Kp] and wp [Kp, N] (f32 codes). `transfer`
    (parts, inv_lsb) → x replaces the IDEAL parts · inv_lsb."""
    lsb, inv_lsb = adc_constants(levels, gain, full_scale)
    m, n = xp.shape[0], wp.shape[1]
    g = xp.shape[1] // n_rows
    # every group's MAC at once: exact, integers < 2^24 in any order
    parts = torch.bmm(xp.reshape(m, g, n_rows).transpose(0, 1),
                      wp.reshape(g, n_rows, n))
    # inv_lsb is an f32 value, so the f32 product is the kernel's
    x = parts * inv_lsb if transfer is None else transfer(parts, inv_lsb)
    code = torch.clamp(torch.round(x), 0.0, float(levels - 1)).double()
    out = torch.zeros(m, n, dtype=torch.float32, device=xp.device)
    for gi in range(g):
        # fma(code, lsb, out): in float64 the product (9 x 24 bits) and the
        # sum are exact, so the one rounding back to f32 is the FMA's
        out = (out.double() + code[gi] * lsb).float()
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


def cim_mvm_grouped_noisy_plain(x: torch.Tensor, w: torch.Tensor, seed, *,
                                n_rows: int, levels: int, gain: float,
                                full_scale: float, sigma: float,
                                inl_amp: float = 0.0, inl_seed: int = 0,
                                apply_inl: bool = False) -> torch.Tensor:
    """Plain version of B5: B2 with the NOISY/FULL transfer. `seed` is an
    int32 scalar (a 1-element tensor or a Python int)."""
    xp = _pad_rows(x.float(), n_rows, 1)
    wp = _pad_rows(w.float(), n_rows, 0)
    return _grouped_adc(xp, wp, n_rows, levels, gain, full_scale,
                        _noisy_transfer(seed, levels=levels, sigma=sigma,
                                        inl_amp=inl_amp, inl_seed=inl_seed,
                                        apply_inl=apply_inl))


def cim_mvm_grouped_noisy_packed_plain(x: torch.Tensor,
                                       w_packed: torch.Tensor, seed, *,
                                       n_rows: int, levels: int, gain: float,
                                       full_scale: float, sigma: float,
                                       inl_amp: float = 0.0,
                                       inl_seed: int = 0,
                                       apply_inl: bool = False
                                       ) -> torch.Tensor:
    """Plain version of B6: B5 over nibble-packed weights [K2, N] uint8."""
    xp = _pad_rows(_pad_rows(x.float(), 2, 1), n_rows, 1)
    wp = unpack_nibbles(_pad_rows(w_packed, n_rows // 2, 0))
    return _grouped_adc(xp, wp, n_rows, levels, gain, full_scale,
                        _noisy_transfer(seed, levels=levels, sigma=sigma,
                                        inl_amp=inl_amp, inl_seed=inl_seed,
                                        apply_inl=apply_inl))


def cim_mvm_grouped_packed_experts_plain(x: torch.Tensor,
                                         w_packed: torch.Tensor,
                                         **kw) -> torch.Tensor:
    """Plain version of B1's expert-batched entry: x [E, M, K] f32 codes,
    w_packed [E, K2, N] uint8 → [E, M, N], B1's plain version on each
    expert in turn (what the reference's vmap over the expert axis
    computes)."""
    return torch.stack([cim_mvm_grouped_packed_plain(x[e], w_packed[e], **kw)
                        for e in range(x.shape[0])])


def cim_mvm_grouped_noisy_packed_experts_plain(x: torch.Tensor,
                                               w_packed: torch.Tensor, seed,
                                               **kw) -> torch.Tensor:
    """Plain version of B6's expert-batched entry: B6's plain version on
    each expert in turn, every expert under the same seed (the counter
    hash takes no expert index, as under the reference's vmap)."""
    return torch.stack([
        cim_mvm_grouped_noisy_packed_plain(x[e], w_packed[e], seed, **kw)
        for e in range(x.shape[0])])


def cim_mvm_grouped_experts_plain(x: torch.Tensor, w: torch.Tensor,
                                  **kw) -> torch.Tensor:
    """Plain version of B2's expert-batched entry: x [E, M, K] f32 codes,
    w [E, K, N] codes → [E, M, N], B2's plain version on each expert in
    turn (what the reference's vmap over the expert axis computes)."""
    return torch.stack([cim_mvm_grouped_plain(x[e], w[e], **kw)
                        for e in range(x.shape[0])])


def cim_mvm_grouped_noisy_experts_plain(x: torch.Tensor, w: torch.Tensor,
                                        seed, **kw) -> torch.Tensor:
    """Plain version of B5's expert-batched entry: B5's plain version on
    each expert in turn, every expert under the same seed (the counter
    hash takes the row within the expert and no expert index, as under the
    reference's vmap)."""
    return torch.stack([cim_mvm_grouped_noisy_plain(x[e], w[e], seed, **kw)
                        for e in range(x.shape[0])])


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# The packed kernels' fallback body stages one macro group of activation
# codes for 8 rows, plus 32 columns of codes, in a CTA's 227 KB of shared
# memory: 8 * (n_rows + 32) f32 values.
PACKED_MAX_ROWS = 227 * 1024 // (4 * 8) - 32


def check_depth(n_rows: int, packed: bool) -> None:
    """Raise for a macro depth the CUDA kernels do not take: the dense
    kernels (B2/B5) take every n_rows >= 1, as the reference's do; the
    packed ones (B1/B6) an even n_rows up to PACKED_MAX_ROWS."""
    if n_rows < 1:
        raise ValueError(f"n_rows={n_rows}: a macro group has at least one "
                         "row")
    if packed and n_rows % 2:
        raise ValueError(f"n_rows={n_rows} unsupported by the packed "
                         "kernels: nibble packing needs an even macro depth "
                         "(as the reference's packed kernels assert)")
    if packed and n_rows > PACKED_MAX_ROWS:
        raise ValueError(f"n_rows={n_rows} unsupported by the packed "
                         f"kernels: at most {PACKED_MAX_ROWS} rows, one "
                         "macro group of activation codes being staged in "
                         "a CTA's shared memory")


def _check_mvm_operands(x: torch.Tensor, w: torch.Tensor, wdtype,
                        n_rows: int) -> None:
    if not w.is_cuda or w.device != x.device:
        raise ValueError("x and w must lie on the same CUDA device")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 2-D float32 tensor")
    if w.dtype != wdtype or w.ndim != 2 or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous 2-D {wdtype} tensor")
    check_depth(n_rows, packed=wdtype == torch.uint8)


def _check_expert_operands(x: torch.Tensor, w: torch.Tensor, wdtype,
                           n_rows: int) -> tuple[int, int, int, int, int]:
    """(E, M, K, KW, N) of an expert-batched MVM's operands: KW = K2 byte
    rows for nibble-packed uint8 w, K rows for dense f32 codes."""
    if not w.is_cuda or w.device != x.device:
        raise ValueError("x and w must lie on the same CUDA device")
    if x.dtype != torch.float32 or x.ndim != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 3-D float32 tensor")
    if w.dtype != wdtype or w.ndim != 3 or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous 3-D {wdtype} tensor")
    packed = wdtype == torch.uint8
    check_depth(n_rows, packed=packed)
    e, m, k = x.shape
    e_w, kw_, n = w.shape
    if e_w != e or k not in ((2 * kw_, 2 * kw_ - 1) if packed else (kw_,)):
        raise ValueError(f"shape mismatch x {tuple(x.shape)} w "
                         f"{tuple(w.shape)}")
    return e, m, k, kw_, n


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


def _check_seed(seed: torch.Tensor, x: torch.Tensor) -> None:
    if not (torch.is_tensor(seed) and seed.device == x.device
            and seed.dtype == torch.int32 and seed.numel() == 1):
        raise ValueError("seed must be a 1-element int32 tensor on x's "
                         "CUDA device")


def _stochastic_args(inv_lsb: float, levels: int, sigma: float,
                     inl_amp: float, inl_seed: int, apply_inl: bool):
    """(mode, salt, sigma, INL constants) as the C entry points take them:
    mode 1 = NOISY, 2 = FULL; the INL array (the code-fraction scale, then
    the instance's constants) is read at launch time."""
    inl = (_frac_scale(inv_lsb, levels),
           *inl_instance(float(inl_amp), int(inl_seed))) if apply_inl \
        else (0.0,) * 10
    return (2 if apply_inl else 1, salt_term(inl_seed), _f32(sigma),
            (ctypes.c_float * 10)(*inl))


def cim_mvm_grouped_noisy(x: torch.Tensor, w: torch.Tensor,
                          seed: torch.Tensor, *, n_rows: int, levels: int,
                          gain: float, full_scale: float, sigma: float,
                          inl_amp: float = 0.0, inl_seed: int = 0,
                          apply_inl: bool = False) -> torch.Tensor:
    """B5: grouped ADC MVM over dense codes with the NOISY/FULL converter,
    x [M, K] f32 × w [K, N] f32 → [M, N] f32. `seed` is a 1-element int32
    tensor on the card (read by the kernel: a new seed needs no rebuild
    and no host sync). Replaces `kernels/cim_mvm.py:cim_mvm_grouped_noisy`
    of the JAX package."""
    kw = dict(n_rows=n_rows, levels=levels, gain=gain, full_scale=full_scale,
              sigma=sigma, inl_amp=inl_amp, inl_seed=inl_seed,
              apply_inl=apply_inl)
    if not x.is_cuda:
        return cim_mvm_grouped_noisy_plain(x, w, seed, **kw)
    _check_mvm_operands(x, w, torch.float32, n_rows)
    _check_seed(seed, x)
    m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"shape mismatch x {tuple(x.shape)} w "
                         f"{tuple(w.shape)}")
    n = w.shape[1]
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    lsb, inv_lsb = adc_constants(levels, gain, full_scale)
    mode, salt, sig, inl = _stochastic_args(inv_lsb, levels, sigma,
                                            inl_amp, inl_seed, apply_inl)
    lib = build.load("cim_mvm")
    rc = lib.cim_mvm_noisy_dense_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, n_rows,
        inv_lsb, lsb, float(levels - 1), mode, seed.data_ptr(), salt, sig,
        inl, torch.cuda.current_stream(x.device).cuda_stream)
    cim_mvm_grouped_noisy.launches += 1
    _check_launch("cim_mvm_grouped_noisy", rc)
    return out


def cim_mvm_grouped_noisy_packed(x: torch.Tensor, w_packed: torch.Tensor,
                                 seed: torch.Tensor, *, n_rows: int,
                                 levels: int, gain: float, full_scale: float,
                                 sigma: float, inl_amp: float = 0.0,
                                 inl_seed: int = 0,
                                 apply_inl: bool = False) -> torch.Tensor:
    """B6: B5 over nibble-packed codes, x [M, K] f32 × w [K2, N] uint8
    (K ≤ 2·K2) → [M, N] f32, bit-identical to B5 under one seed. Replaces
    `kernels/cim_mvm.py:cim_mvm_grouped_noisy_packed` of the JAX
    package."""
    kw = dict(n_rows=n_rows, levels=levels, gain=gain, full_scale=full_scale,
              sigma=sigma, inl_amp=inl_amp, inl_seed=inl_seed,
              apply_inl=apply_inl)
    if not x.is_cuda:
        return cim_mvm_grouped_noisy_packed_plain(x, w_packed, seed, **kw)
    _check_mvm_operands(x, w_packed, torch.uint8, n_rows)
    _check_seed(seed, x)
    m, k = x.shape
    k2, n = w_packed.shape
    if k not in (2 * k2, 2 * k2 - 1):
        raise ValueError(f"shape mismatch x {tuple(x.shape)} w_packed "
                         f"{tuple(w_packed.shape)}")
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    lsb, inv_lsb = adc_constants(levels, gain, full_scale)
    mode, salt, sig, inl = _stochastic_args(inv_lsb, levels, sigma,
                                            inl_amp, inl_seed, apply_inl)
    lib = build.load("cim_mvm")
    rc = lib.cim_mvm_noisy_packed_launch(
        x.data_ptr(), w_packed.data_ptr(), out.data_ptr(), m, n, k, k2,
        n_rows, inv_lsb, lsb, float(levels - 1), mode, seed.data_ptr(), salt,
        sig, inl, torch.cuda.current_stream(x.device).cuda_stream)
    cim_mvm_grouped_noisy_packed.launches += 1
    _check_launch("cim_mvm_grouped_noisy_packed", rc)
    return out


def cim_mvm_grouped_packed_experts(x: torch.Tensor, w_packed: torch.Tensor,
                                   *, n_rows: int, levels: int, gain: float,
                                   full_scale: float) -> torch.Tensor:
    """B1, expert-batched: x [E, M, K] f32 × w [E, K2, N] uint8 → [E, M, N]
    f32 in one launch, expert e bit-identical to B1 on (x[e], w[e]).
    Replaces `kernels/cim_mvm.py:cim_mvm_grouped_packed` of the JAX package
    under `jax.vmap` over the routed experts (`models/moe.py`)."""
    kw = dict(n_rows=n_rows, levels=levels, gain=gain, full_scale=full_scale)
    if not x.is_cuda:
        return cim_mvm_grouped_packed_experts_plain(x, w_packed, **kw)
    e, m, k, k2, n = _check_expert_operands(x, w_packed, torch.uint8,
                                            n_rows)
    out = torch.empty(e, m, n, dtype=torch.float32, device=x.device)
    lsb, inv_lsb = adc_constants(levels, gain, full_scale)
    lib = build.load("cim_mvm")
    rc = lib.cim_mvm_packed_experts_launch(
        x.data_ptr(), w_packed.data_ptr(), out.data_ptr(), e, m, n, k, k2,
        n_rows, inv_lsb, lsb, float(levels - 1),
        torch.cuda.current_stream(x.device).cuda_stream)
    cim_mvm_grouped_packed_experts.launches += 1
    _check_launch("cim_mvm_grouped_packed_experts", rc)
    return out


def cim_mvm_grouped_noisy_packed_experts(x: torch.Tensor,
                                         w_packed: torch.Tensor,
                                         seed: torch.Tensor, *, n_rows: int,
                                         levels: int, gain: float,
                                         full_scale: float, sigma: float,
                                         inl_amp: float = 0.0,
                                         inl_seed: int = 0,
                                         apply_inl: bool = False
                                         ) -> torch.Tensor:
    """B6, expert-batched: x [E, M, K] f32 × w [E, K2, N] uint8 → [E, M, N]
    f32 in one launch, expert e bit-identical to B6 on (x[e], w[e]) under
    the same seed: the counter hash takes the row within the expert and no
    expert index, so every expert draws the same noise at the same
    coordinates, as the reference's Pallas kernel does under vmap."""
    kw = dict(n_rows=n_rows, levels=levels, gain=gain, full_scale=full_scale,
              sigma=sigma, inl_amp=inl_amp, inl_seed=inl_seed,
              apply_inl=apply_inl)
    if not x.is_cuda:
        return cim_mvm_grouped_noisy_packed_experts_plain(x, w_packed, seed,
                                                          **kw)
    e, m, k, k2, n = _check_expert_operands(x, w_packed, torch.uint8,
                                            n_rows)
    _check_seed(seed, x)
    out = torch.empty(e, m, n, dtype=torch.float32, device=x.device)
    lsb, inv_lsb = adc_constants(levels, gain, full_scale)
    mode, salt, sig, inl = _stochastic_args(inv_lsb, levels, sigma,
                                            inl_amp, inl_seed, apply_inl)
    lib = build.load("cim_mvm")
    rc = lib.cim_mvm_noisy_packed_experts_launch(
        x.data_ptr(), w_packed.data_ptr(), out.data_ptr(), e, m, n, k, k2,
        n_rows, inv_lsb, lsb, float(levels - 1), mode, seed.data_ptr(), salt,
        sig, inl, torch.cuda.current_stream(x.device).cuda_stream)
    cim_mvm_grouped_noisy_packed_experts.launches += 1
    _check_launch("cim_mvm_grouped_noisy_packed_experts", rc)
    return out


def cim_mvm_grouped_experts(x: torch.Tensor, w: torch.Tensor, *,
                            n_rows: int, levels: int, gain: float,
                            full_scale: float) -> torch.Tensor:
    """B2, expert-batched: x [E, M, K] f32 × w [E, K, N] f32 codes →
    [E, M, N] f32 in one launch, expert e bit-identical to B2 on (x[e],
    w[e]). Replaces `kernels/cim_mvm.py:cim_mvm_grouped` of the JAX package
    under `jax.vmap` over the routed experts (`models/moe.py`)."""
    kw = dict(n_rows=n_rows, levels=levels, gain=gain, full_scale=full_scale)
    if not x.is_cuda:
        return cim_mvm_grouped_experts_plain(x, w, **kw)
    e, m, k, _, n = _check_expert_operands(x, w, torch.float32, n_rows)
    out = torch.empty(e, m, n, dtype=torch.float32, device=x.device)
    lsb, inv_lsb = adc_constants(levels, gain, full_scale)
    lib = build.load("cim_mvm")
    rc = lib.cim_mvm_dense_experts_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), e, m, n, k, n_rows,
        inv_lsb, lsb, float(levels - 1),
        torch.cuda.current_stream(x.device).cuda_stream)
    cim_mvm_grouped_experts.launches += 1
    _check_launch("cim_mvm_grouped_experts", rc)
    return out


def cim_mvm_grouped_noisy_experts(x: torch.Tensor, w: torch.Tensor,
                                  seed: torch.Tensor, *, n_rows: int,
                                  levels: int, gain: float, full_scale: float,
                                  sigma: float, inl_amp: float = 0.0,
                                  inl_seed: int = 0,
                                  apply_inl: bool = False) -> torch.Tensor:
    """B5, expert-batched: x [E, M, K] f32 × w [E, K, N] f32 codes →
    [E, M, N] f32 in one launch, expert e bit-identical to B5 on (x[e],
    w[e]) under the same seed: the counter hash takes the row within the
    expert and no expert index, as the reference's Pallas kernel under
    vmap."""
    kw = dict(n_rows=n_rows, levels=levels, gain=gain, full_scale=full_scale,
              sigma=sigma, inl_amp=inl_amp, inl_seed=inl_seed,
              apply_inl=apply_inl)
    if not x.is_cuda:
        return cim_mvm_grouped_noisy_experts_plain(x, w, seed, **kw)
    e, m, k, _, n = _check_expert_operands(x, w, torch.float32, n_rows)
    _check_seed(seed, x)
    out = torch.empty(e, m, n, dtype=torch.float32, device=x.device)
    lsb, inv_lsb = adc_constants(levels, gain, full_scale)
    mode, salt, sig, inl = _stochastic_args(inv_lsb, levels, sigma,
                                            inl_amp, inl_seed, apply_inl)
    lib = build.load("cim_mvm")
    rc = lib.cim_mvm_noisy_dense_experts_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), e, m, n, k, n_rows,
        inv_lsb, lsb, float(levels - 1), mode, seed.data_ptr(), salt, sig,
        inl, torch.cuda.current_stream(x.device).cuda_stream)
    cim_mvm_grouped_noisy_experts.launches += 1
    _check_launch("cim_mvm_grouped_noisy_experts", rc)
    return out


cim_mvm_grouped.launches = 0
cim_mvm_grouped_packed.launches = 0
cim_mvm_grouped_noisy.launches = 0
cim_mvm_grouped_noisy_packed.launches = 0
cim_mvm_grouped_packed_experts.launches = 0
cim_mvm_grouped_noisy_packed_experts.launches = 0
cim_mvm_grouped_experts.launches = 0
cim_mvm_grouped_noisy_experts.launches = 0

# ctypes signatures of the C entry points in csrc/cim_mvm.cu
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_FA = ctypes.POINTER(ctypes.c_float)
build.declare("cim_mvm", {
    "cim_mvm_dense_launch": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P],
    "cim_mvm_packed_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F,
                              _P],
    "cim_mvm_noisy_dense_launch": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                                   _I, _P, _U, _F, _FA, _P],
    "cim_mvm_noisy_packed_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                                    _F, _I, _P, _U, _F, _FA, _P],
    "cim_mvm_packed_experts_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _F, _F, _F, _P],
    "cim_mvm_noisy_packed_experts_launch": [_P, _P, _P, _I, _I, _I, _I, _I,
                                            _I, _F, _F, _F, _I, _P, _U, _F,
                                            _FA, _P],
    "cim_mvm_dense_experts_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                                     _F, _P],
    "cim_mvm_noisy_dense_experts_launch": [_P, _P, _P, _I, _I, _I, _I, _I,
                                           _F, _F, _F, _I, _P, _U, _F, _FA,
                                           _P],
})
