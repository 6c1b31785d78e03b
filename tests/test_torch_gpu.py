"""The port's Hopper kernels against their plain PyTorch versions, on the
card (marker `gpu`; each test skips without a CUDA device). Run there with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

B1, B2, B4, B5 and B6 must be bit-exact (B2/B5 at every macro depth,
B1/B6 at every even one) (B5/B6 at NOISY and at FULL: the
kernel's sinf and torch.sin on the card are the same CUDA sinf); B3 too,
since its plain version follows the kernel's operation order on the same
device, with a bfloat16 output equal to the plain f32 output rounded by
`.to(torch.bfloat16)`. B4 runs inside B3's decode launch: that launch
must equal B4's plain version followed by B3's, on the outputs and on
every byte of both pools. B3 and that launch are held so at head dims and
block sizes past their fast case too (dh 16, 20, 21, 56, 80, 96; bs 48,
64, 128), and a speculative verify step (C = 5, every position's logits)
of the smoke model is identical with the kernels and with their plain
versions, as is a telemetry-on serve with parallel samples and the trie
watermark sweep (streams, metrics and event kinds). Inputs come from
numpy seeds. This file needs no JAX.
"""
import numpy as np
import pytest
import torch

from _torch_helpers import gpu_device

from repro_torch.kernels import cim_mvm, ops
from repro_torch.kernels import paged_attention as pa

pytestmark = pytest.mark.gpu

KW = dict(n_rows=144, levels=362, gain=1.0, full_scale=32400.0)


def _codes(seed, shape):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 16, shape).astype(np.float32))


# the last four: group counts that are no multiple of the packed MVM's
# cluster size (G = 15, 11, 11, 63 over clusters of 4, 6, 2, 8 CTAs) and K
# no multiple of the 144-row group (2047 is odd: its last byte row holds
# one code)
SHAPES = [(1, 1, 1), (3, 301, 70), (5, 288, 129), (130, 145, 257),
          (4, 2048, 2048), (64, 2048, 1024), (4, 8192, 2048),
          (1, 2047, 1024), (8, 1500, 96), (64, 1441, 160), (4, 9000, 48)]
NOISY = dict(KW, sigma=0.277)
FULL = dict(KW, sigma=0.277, inl_amp=1.1, apply_inl=True)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_b1_b2_bit_exact_vs_plain(m, k, n):
    dev = gpu_device()
    x = _codes(m, (m, k)).to(dev)
    w = _codes(n, (k, n)).to(dev)
    wp = ops.pack_codes(w).contiguous()
    before = cim_mvm.cim_mvm_grouped.launches
    assert torch.equal(cim_mvm.cim_mvm_grouped(x, w, **KW),
                       cim_mvm.cim_mvm_grouped_plain(x, w, **KW))
    assert torch.equal(cim_mvm.cim_mvm_grouped_packed(x, wp, **KW),
                       cim_mvm.cim_mvm_grouped_packed_plain(x, wp, **KW))
    assert cim_mvm.cim_mvm_grouped.launches == before + 1


@pytest.mark.parametrize("level", ["noisy", "full"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_b5_b6_bit_exact_vs_plain(m, k, n, level):
    dev = gpu_device()
    x = _codes(m + 1, (m, k)).to(dev)
    w = _codes(n + 1, (k, n)).to(dev)
    wp = ops.pack_codes(w).contiguous()
    kw = NOISY if level == "noisy" else FULL
    for seed, inl_seed in ((0, 0), (7, 3)):
        s = torch.tensor([seed], dtype=torch.int32, device=dev)
        y5 = cim_mvm.cim_mvm_grouped_noisy(x, w, s, inl_seed=inl_seed, **kw)
        y6 = cim_mvm.cim_mvm_grouped_noisy_packed(x, wp, s, inl_seed=inl_seed,
                                                  **kw)
        assert torch.isfinite(y5).all()
        assert torch.equal(y5, cim_mvm.cim_mvm_grouped_noisy_plain(
            x, w, s, inl_seed=inl_seed, **kw))
        assert torch.equal(y6, cim_mvm.cim_mvm_grouped_noisy_packed_plain(
            x, wp, s, inl_seed=inl_seed, **kw))
        assert torch.equal(y6, y5)


@pytest.mark.parametrize("level", ["ideal", "noisy"])
def test_b1_b6_groups_of_rows_not_a_multiple_of_four(level):
    """146-row groups split a four-row int8 word across two groups, so the
    packed MVM takes the one-block-per-32-columns body there; it stays
    bit-exact against the plain versions."""
    dev = gpu_device()
    kw = dict(KW, n_rows=146)
    x = _codes(11, (4, 700)).to(dev)
    wp = ops.pack_codes(_codes(12, (700, 96)).to(dev)).contiguous()
    if level == "ideal":
        assert torch.equal(cim_mvm.cim_mvm_grouped_packed(x, wp, **kw),
                           cim_mvm.cim_mvm_grouped_packed_plain(x, wp, **kw))
        return
    s = torch.tensor([7], dtype=torch.int32, device=dev)
    kw = dict(kw, sigma=0.277)
    assert torch.equal(
        cim_mvm.cim_mvm_grouped_noisy_packed(x, wp, s, **kw),
        cim_mvm.cim_mvm_grouped_noisy_packed_plain(x, wp, s, **kw))


# Shapes that reach each path of the dense MVM's dispatch (B2/B5), as
# (M, K, N, n_rows): clusters of 1 (w_gate/w_up, the head, most prefill
# shapes), 2 (wq/wo, wk/wv, w_down), 4 and 8 CTAs (small N; prefill
# w_down, where a CTA must stay within half an SM's shared memory; 228
# groups of 9 rows), with group counts that are no multiple of the
# cluster size (15 over 2, 57 over 4, 10 over 4, 63 over 8); N % 4 != 0
# (scalar weight loads); warps side by side (N = 4096 and 8192 at M > 4);
# M from 1 to 130; the macro depths 9, 145 and 1024; groups staged in
# passes where no cluster holds them (n_rows = 1, K = 12000) and one
# group's rows in windows (n_rows = 7400). SHAPES above reach clusters of
# 2 to 8 as well.
DENSE_SHAPES = [
    (4, 2048, 2048, 144), (4, 2048, 1024, 144), (4, 2048, 8192, 144),
    (4, 8192, 2048, 144), (64, 2048, 2048, 144), (64, 8192, 2048, 144),
    (65, 2048, 4096, 144), (2, 1300, 300, 144), (4, 2048, 18, 144),
    (4, 2048, 2050, 144), (9, 3000, 514, 144), (17, 700, 1026, 144),
    (3, 301, 70, 144), (1, 2047, 1024, 144), (130, 145, 257, 144),
    (4, 2048, 2048, 9), (64, 2048, 2048, 9), (4, 2048, 2048, 145),
    (64, 2048, 2048, 145), (4, 2048, 2048, 1024), (64, 2048, 2048, 1024),
    (64, 2048, 1024, 9), (4, 9000, 48, 144), (4, 12000, 16, 1),
    (9, 14800, 40, 7400), (5, 1500, 520, 144), (8, 1500, 520, 144),
    (16, 1500, 520, 144), (33, 1500, 520, 144), (100, 1500, 520, 144)]


def _depth_kw(n_rows, level):
    kw = dict(KW, n_rows=n_rows, full_scale=225.0 * n_rows)
    if level == "ideal":
        return kw
    return dict(kw, **{k: v for k, v in (NOISY if level == "noisy"
                                         else FULL).items() if k not in KW})


@pytest.mark.parametrize("level", ["ideal", "noisy", "full"])
@pytest.mark.parametrize("m,k,n,n_rows", DENSE_SHAPES)
def test_b2_b5_dense_paths_bit_exact_vs_plain(m, k, n, n_rows, level):
    """B2 (IDEAL) and B5 (NOISY, FULL) against their plain versions on
    every path of the dense dispatch; B6 equal to B5 where the depth is
    one the packed kernels take."""
    dev = gpu_device()
    x = _codes(m + 2, (m, k)).to(dev)
    w = _codes(n + 2, (k, n)).to(dev)
    kw = _depth_kw(n_rows, level)
    if level == "ideal":
        before = cim_mvm.cim_mvm_grouped.launches
        assert torch.equal(cim_mvm.cim_mvm_grouped(x, w, **kw),
                           cim_mvm.cim_mvm_grouped_plain(x, w, **kw))
        assert cim_mvm.cim_mvm_grouped.launches == before + 1
        return
    s = torch.tensor([7], dtype=torch.int32, device=dev)
    y5 = cim_mvm.cim_mvm_grouped_noisy(x, w, s, inl_seed=3, **kw)
    assert torch.isfinite(y5).all()
    assert torch.equal(y5, cim_mvm.cim_mvm_grouped_noisy_plain(
        x, w, s, inl_seed=3, **kw))
    if n_rows % 2 == 0 and n_rows <= cim_mvm.PACKED_MAX_ROWS:
        wp = ops.pack_codes(w).contiguous()
        assert torch.equal(cim_mvm.cim_mvm_grouped_noisy_packed(
            x, wp, s, inl_seed=3, **kw), y5)


@pytest.mark.parametrize("level", ["ideal", "noisy"])
@pytest.mark.parametrize("m", [4, 64])
def test_b2_b5_weights_not_16_byte_aligned(m, level):
    """A contiguous w at a storage offset of one element: the dense
    kernel takes scalar loads instead of 16-byte ones."""
    dev = gpu_device()
    k, n = 2048, 1024
    x = _codes(5, (m, k)).to(dev)
    store = torch.zeros(k * n + 1, device=dev)
    w = store[1:].view(k, n)
    w.copy_(_codes(6, (k, n)).to(dev))
    assert w.is_contiguous() and w.data_ptr() % 16 != 0
    if level == "ideal":
        assert torch.equal(cim_mvm.cim_mvm_grouped(x, w, **KW),
                           cim_mvm.cim_mvm_grouped_plain(x, w, **KW))
        return
    s = torch.tensor([0], dtype=torch.int32, device=dev)
    assert torch.equal(cim_mvm.cim_mvm_grouped_noisy(x, w, s, **NOISY),
                       cim_mvm.cim_mvm_grouped_noisy_plain(x, w, s, **NOISY))


@pytest.mark.parametrize("n_rows", [426, 1024])
@pytest.mark.parametrize("m", [4, 64])
def test_b1_b6_deep_groups(m, n_rows):
    """Deep even groups: 1024 rows take the packed cluster kernel, 426
    rows (no multiple of four) the fallback body, which at M > 4 stages
    fewer than 16 groups per pass to fit its shared memory."""
    dev = gpu_device()
    kw = _depth_kw(n_rows, "ideal")
    x = _codes(m + 50, (m, 3000)).to(dev)
    w = _codes(51, (3000, 200)).to(dev)
    wp = ops.pack_codes(w).contiguous()
    y2 = cim_mvm.cim_mvm_grouped(x, w, **kw)
    assert torch.equal(cim_mvm.cim_mvm_grouped_packed(x, wp, **kw), y2)
    assert torch.equal(y2, cim_mvm.cim_mvm_grouped_plain(x, w, **kw))
    nkw = _depth_kw(n_rows, "noisy")
    s = torch.tensor([7], dtype=torch.int32, device=dev)
    assert torch.equal(
        cim_mvm.cim_mvm_grouped_noisy_packed(x, wp, s, **nkw),
        cim_mvm.cim_mvm_grouped_noisy(x, w, s, **nkw))


def test_dense_takes_odd_depths_packed_rejects_them():
    dev = gpu_device()
    kw = _depth_kw(9, "ideal")
    x = _codes(60, (4, 300)).to(dev)
    w = _codes(61, (300, 40)).to(dev)
    assert torch.equal(cim_mvm.cim_mvm_grouped(x, w, **kw),
                       cim_mvm.cim_mvm_grouped_plain(x, w, **kw))
    with pytest.raises(ValueError, match="even macro depth"):
        cim_mvm.cim_mvm_grouped_packed(x, ops.pack_codes(w).contiguous(),
                                       **kw)


def test_b5_seed_is_read_on_the_card():
    """A new seed value in the same tensor changes the draws (no rebuild,
    no host copy), and inl_seed salts them."""
    dev = gpu_device()
    x = _codes(3, (4, 2048)).to(dev)
    w = _codes(4, (2048, 256)).to(dev)
    s = torch.zeros(1, dtype=torch.int32, device=dev)
    y0 = cim_mvm.cim_mvm_grouped_noisy(x, w, s, **NOISY)
    s.fill_(7)
    y7 = cim_mvm.cim_mvm_grouped_noisy(x, w, s, **NOISY)
    assert not torch.equal(y0, y7)
    assert not torch.equal(y7, cim_mvm.cim_mvm_grouped_noisy(
        x, w, s, inl_seed=3, **NOISY))
    with pytest.raises(ValueError, match="seed"):
        cim_mvm.cim_mvm_grouped_noisy(x, w, s.cpu(), **NOISY)


def test_b1_rejects_bad_operands():
    dev = gpu_device()
    x = _codes(0, (4, 300)).to(dev)
    with pytest.raises(ValueError):
        cim_mvm.cim_mvm_grouped_packed(x, torch.zeros(10, 8, dtype=torch.uint8,
                                                      device=dev), **KW)
    with pytest.raises(ValueError):
        cim_mvm.cim_mvm_grouped_packed(x, torch.zeros(150, 8, device=dev),
                                       **KW)


def _attn_case(seed, c, dtype, dev, b=4, kh=8, g=2, dh=128, bs=16, mb=16):
    """Mixed depths: slot 0 idle, slot 1 ending on a split boundary (the
    later ranks read nothing), slot 2 mid-window, slot 3 the whole window;
    the trash block (block 0) is NaN."""
    rng = np.random.RandomState(seed)
    nb = b * mb + 1
    w = mb * bs
    per = pa.attn_splits(mb)[1]
    q = torch.from_numpy(rng.standard_normal((b, c, kh * g, dh))
                         .astype(np.float32)).to(dev)
    kp = torch.from_numpy(rng.standard_normal((nb, bs, kh, dh))
                          .astype(np.float32)).to(dev, dtype)
    vp = torch.from_numpy(rng.standard_normal((nb, bs, kh, dh))
                          .astype(np.float32)).to(dev, dtype)
    kp[0] = float("nan")
    vp[0] = float("nan")
    lens = torch.tensor([0, max(0, per * bs - c), min(w // 2 + 3, w - c),
                         w - c], dtype=torch.int32, device=dev)
    kvl = lens + torch.tensor([0, c, c, c], dtype=torch.int32, device=dev)
    tables = torch.from_numpy(rng.permutation(np.arange(1, nb))
                              .astype(np.int32).reshape(b, mb)).to(dev)
    return q, kp, vp, tables, lens, kvl


def _same_bits(a, b):
    """Equal bit for bit (NaN included)."""
    ints = {2: torch.int16, 4: torch.int32}
    return a.dtype == b.dtype and torch.equal(
        a.view(ints[a.element_size()]), b.view(ints[b.element_size()]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("mb", [5, 16, 17])
@pytest.mark.parametrize("c", [1, 5, 16])
def test_b3_bit_exact_vs_plain(c, mb, bs, dh, dtype):
    dev = gpu_device()
    case = _attn_case(7, c, dtype, dev, dh=dh, bs=bs, mb=mb)
    before = pa.paged_attn_call.launches
    out = pa.paged_attn_call(*case)
    ref = pa.paged_attn_plain(*case)
    assert pa.paged_attn_call.launches == before + 1
    assert torch.isfinite(out).all()
    assert torch.equal(out, ref)
    assert (out[0] == 0).all()
    # q read as bfloat16, the output written as bfloat16
    q16 = case[0].bfloat16()
    out16 = pa.paged_attn_call(q16, *case[1:], out_dtype=torch.bfloat16)
    ref16 = pa.paged_attn_plain(q16, *case[1:])
    assert out16.dtype == torch.bfloat16
    assert _same_bits(out16, ref16.to(torch.bfloat16))


def _decode_writes(case, dtype, dev):
    """New K/V rows (pool dtype) and the flat write targets of a C = 1
    `_attn_case`: slot s writes at its position lens[s] (slot 0 idle:
    flat 0)."""
    q, kp, _, tables, lens, _ = case
    b = q.shape[0]
    _, bs, kh, dh = kp.shape
    rng = np.random.RandomState(b * dh + bs)
    nk = torch.from_numpy(rng.standard_normal((b, 1, kh, dh))
                          .astype(np.float32)).to(dev, dtype)
    nv = torch.from_numpy(rng.standard_normal((b, 1, kh, dh))
                          .astype(np.float32)).to(dev, dtype)
    col = (lens // bs).long()
    flat = (tables.gather(1, col[:, None])[:, 0] * bs + lens % bs).int()
    flat[0] = 0
    return nk, nv, flat


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("mb", [5, 16, 17])
def test_b3_b4_decode_launch_bit_exact_vs_plain(mb, bs, dh, dtype):
    """The fused decode launch against fused_write_plain + paged_attn_plain:
    slot 1 writes at offset bs - 1 of rank 0's last column, slots 2 and 3
    into blocks of ranks > 0; slot 0 is idle (flat 0); the trash block is
    NaN. Outputs and both pools bit-exact, at f32 and at bf16 q/output."""
    dev = gpu_device()
    case = _attn_case(8, 1, dtype, dev, dh=dh, bs=bs, mb=mb)
    q, kp, vp, tables, lens, kvl = case
    nk, nv, flat = _decode_writes(case, dtype, dev)
    per = pa.attn_splits(mb)[1]
    assert (lens[2:] // bs // per > 0).all()     # write blocks of ranks > 0
    for qx, out_dtype in ((q, torch.float32),
                          (q.bfloat16(), torch.bfloat16)):
        k2, v2, k3, v3 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        before = pa.decode_write_attend_call.launches
        out = pa.decode_write_attend_call(qx, k2, v2, nk, nv, flat, tables,
                                          lens, kvl, out_dtype=out_dtype)
        ref = pa.decode_write_attend_plain(qx, k3, v3, nk, nv, flat, tables,
                                           lens, kvl).to(out_dtype)
        assert pa.decode_write_attend_call.launches == before + 1
        assert torch.isfinite(out).all() and (out[0] == 0).all()
        assert _same_bits(out, ref)
        assert _same_bits(k2, k3) and _same_bits(v2, v3)
        assert not _same_bits(k2, kp)               # the rows were written
        assert _same_bits(k2[0], kp[0])             # flat 0: no write


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b4_bit_exact_vs_plain(dtype):
    """B4 inside the decode launch: three writes, one invalid lane, new
    rows and tables given as the caller holds them (int64 indices)."""
    dev = gpu_device()
    g = torch.Generator(device="cpu").manual_seed(8)
    kp = torch.randn(9, 16, 8, 128, generator=g).to(dev, dtype)
    vp = torch.randn(9, 16, 8, 128, generator=g).to(dev, dtype)
    nk = torch.randn(4, 1, 8, 128, generator=g).to(dev, dtype)
    nv = torch.randn(4, 1, 8, 128, generator=g).to(dev, dtype)
    q = torch.randn(4, 1, 16, 128, generator=g).to(dev)
    flat = torch.tensor([[17], [0], [40], [143]], device=dev)
    # each slot's table maps its write block at its position
    tables = torch.tensor([[1, 0], [0, 0], [2, 0], [7, 8]], device=dev)
    lens = torch.tensor([1, 0, 8, 31], device=dev)
    kvl = lens + torch.tensor([1, 0, 1, 1], device=dev)
    k2, v2, k3, v3 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    out = pa.decode_write_attend_call(q, k2, v2, nk, nv, flat, tables, lens,
                                      kvl)
    ref = pa.decode_write_attend_plain(q, k3, v3, nk, nv, flat, tables, lens,
                                       kvl)
    assert torch.equal(k2, k3) and torch.equal(v2, v3)
    assert torch.equal(k2[0], kp[0])       # flat 0: no write
    assert torch.equal(out, ref)


# Head dims and block sizes past B3's fast case (dh in {32, 64, 128, 256},
# bs <= 32): rows of bf16 dh 20 are 40 bytes (8-byte copies), of dh 21 42
# bytes in bf16 (2-byte copies) and 84 in f32 (4-byte copies); dh 56 is
# deepseek-v3's MLA head dim, dh 80 stablelm-3b's; bs > 32 is scored in
# pieces of 32 tokens.
C1_SHAPES = [(16, 16), (20, 16), (21, 8), (56, 16), (80, 16), (96, 8),
             (128, 48), (128, 64), (80, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,bs", C1_SHAPES)
@pytest.mark.parametrize("c", [1, 5, 16])
def test_b3_any_head_dim_and_block_size_bit_exact(c, dh, bs, dtype):
    dev = gpu_device()
    case = _attn_case(10, c, dtype, dev, dh=dh, bs=bs, mb=16)
    out = pa.paged_attn_call(*case)
    ref = pa.paged_attn_plain(*case)
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    assert torch.equal(out, ref)
    q16 = case[0].bfloat16()
    out16 = pa.paged_attn_call(q16, *case[1:], out_dtype=torch.bfloat16)
    assert _same_bits(out16, pa.paged_attn_plain(q16, *case[1:])
                      .to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,bs", C1_SHAPES)
@pytest.mark.parametrize("mb", [5, 16])
def test_b3_b4_decode_launch_any_head_dim_and_block_size(mb, dh, bs, dtype):
    dev = gpu_device()
    case = _attn_case(11, 1, dtype, dev, dh=dh, bs=bs, mb=mb)
    q, kp, vp, tables, lens, kvl = case
    nk, nv, flat = _decode_writes(case, dtype, dev)
    k2, v2, k3, v3 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    out = pa.decode_write_attend_call(q, k2, v2, nk, nv, flat, tables, lens,
                                      kvl)
    ref = pa.decode_write_attend_plain(q, k3, v3, nk, nv, flat, tables, lens,
                                       kvl)
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    assert _same_bits(out, ref)
    assert _same_bits(k2, k3) and _same_bits(v2, v3)
    assert not _same_bits(k2, kp) and _same_bits(k2[0], kp[0])


def test_b3_rejects_what_the_reference_rejects():
    dev = gpu_device()
    q, kp, vp, tables, lens, kvl = _attn_case(12, 1, torch.float32, dev,
                                              dh=80, bs=16, mb=5)
    with pytest.raises(ValueError, match="shape mismatch"):   # KH ∤ H
        pa.paged_attn_call(q[:, :, :15], kp, vp, tables, lens, kvl)
    wide = torch.zeros(*kp.shape[:3], 257, device=dev)
    with pytest.raises(ValueError, match="1 <= dh <= 256"):
        pa.paged_attn_call(torch.zeros(*q.shape[:3], 257, device=dev), wide,
                           wide, tables, lens, kvl)


def test_verify_step_kernels_bit_exact_vs_plain():
    """A speculative verify step (C = spec_k + 1 = 5, all positions'
    logits) at decode depth on the smoke model under --cim bp-prequant:
    the kernels (B1, B3 after paged_write) against their plain versions,
    logits and pools identical."""
    import dataclasses
    from repro_torch.configs.registry import SMOKES
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.models import quantize, registry, transformer
    dev = gpu_device()
    cfg = SMOKES["internlm2-1.8b"].replace(cim=CIMConfig(enabled=True))
    params = quantize.quantize_params(
        registry.init_params(cfg, seed=0, device=dev), cfg, packed=True)
    rng = np.random.RandomState(13)
    tables = torch.arange(1, 17, dtype=torch.int32, device=dev).reshape(4, 4)
    runs = []
    for step_cfg in (cfg, cfg.replace(attn_backend="plain", cim=dataclasses
                                      .replace(cfg.cim, backend="plain"))):
        cache = transformer.init_paged_cache(step_cfg, 17, 16, device=dev)
        toks = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 16))).to(dev)
        lens = torch.zeros(4, dtype=torch.int32, device=dev)
        valid = torch.tensor([16, 16, 9, 0], dtype=torch.int32, device=dev)
        _, cache = transformer.paged_step(params, toks, cache, tables, lens,
                                          valid, step_cfg)
        draft = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 5))).to(dev)
        logits, cache = transformer.paged_step(
            params, draft, cache, tables, valid,
            torch.tensor([5, 3, 1, 0], dtype=torch.int32, device=dev),
            step_cfg, all_logits=True)
        runs.append((logits, cache["layers"]))
        rng = np.random.RandomState(13)
    (lk, pk), (lp, pp) = runs
    assert lk.shape == (4, 5, cfg.vocab) and torch.isfinite(lk[:3]).all()
    assert torch.equal(lk[:3], lp[:3])
    assert _same_bits(pk["k"][:, 1:], pp["k"][:, 1:])
    assert _same_bits(pk["v"][:, 1:], pp["v"][:, 1:])


def test_decode_launch_rejects_bad_operands():
    dev = gpu_device()
    case = _attn_case(9, 1, torch.bfloat16, dev, dh=128, bs=16, mb=16)
    q, kp, vp, tables, lens, kvl = case
    nk, nv, flat = _decode_writes(case, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="bfloat16"):     # pool dtype
        pa.decode_write_attend_call(q, kp, vp, nk.float(), nv, flat, tables,
                                    lens, kvl)
    strided = nk.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        pa.decode_write_attend_call(q, kp, vp, strided, nv, flat, tables,
                                    lens, kvl)
    q16 = torch.cat([q, q], 1)
    with pytest.raises(ValueError, match="C = 1"):
        pa.decode_write_attend_call(q16, kp, vp, nk, nv, flat, tables, lens,
                                    kvl)


def _telemetry_serve(cfg, dev):
    """The smoke model served with telemetry on (a unit-step fake clock),
    requests 0 and 1 at n_samples 2, trie_watermark 0.5 over a 24-block
    pool: (streams, ServerMetrics.to_dict(), event kinds in order)."""
    from repro_torch.models import registry
    from repro_torch.runtime.server import Request, Server, ServingConfig
    from repro_torch.runtime.telemetry import Telemetry
    ticks = iter(range(1, 1 << 30))
    params = registry.init_params(cfg, seed=0, device=dev)
    srv = Server(params, cfg, ServingConfig(
        n_slots=4, max_len=64, block_size=8, num_blocks=24,
        prefill_chunk=8, prequant=True, attn=cfg.attn_backend,
        trie_watermark=0.5), telemetry=Telemetry(
            clock=lambda: float(next(ticks))), device=dev)
    rng = np.random.RandomState(17)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab, size=int(n)).tolist(),
                    max_new_tokens=6, n_samples=2 if i < 2 else 1)
            for i, n in enumerate(rng.randint(17, 41, size=6))]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    streams = [x.output for r in reqs for x in (r, *r.samples)]
    return streams, srv.metrics.to_dict(), [e.kind for e in
                                            srv.telemetry.events]


def test_telemetry_serve_kernels_match_plain():
    """Telemetry on, parallel samples and the trie sweep: the kernel
    backends (B1, B3, the B3+B4 decode launch) and their plain versions
    serve identical streams, metrics and event kinds."""
    import dataclasses
    from repro_torch.configs.registry import SMOKES
    from repro_torch.core.cim_matmul import CIMConfig
    dev = gpu_device()
    cfg = SMOKES["internlm2-1.8b"].replace(cim=CIMConfig(enabled=True),
                                           attn_backend="kernel")
    kern = _telemetry_serve(cfg, dev)
    plain = _telemetry_serve(cfg.replace(
        attn_backend="plain", cim=dataclasses.replace(cfg.cim,
                                                      backend="plain")), dev)
    assert kern == plain
    streams, metrics, kinds = kern
    assert len(streams) == 8 and all(len(s) == 6 for s in streams)
    assert metrics["cow_forks"] > 0 and metrics["trie_sweep_freed"] > 0
    assert {"cow_fork", "first_token", "decode", "retire"} <= set(kinds)
