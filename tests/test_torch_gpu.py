"""The port's Hopper kernels against their plain PyTorch versions, on the
card (marker `gpu`; each test skips without a CUDA device). Run there with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

B1, B2, B4, B5 and B6 must be bit-exact (B2/B5 at every macro depth,
B1/B6 at every even one) (B5/B6 at NOISY and at FULL: the
kernel's sinf and torch.sin on the card are the same CUDA sinf); B3 too,
since its plain version follows the kernel's operation order on the same
device. Inputs come from numpy seeds. This file needs no JAX.
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("mb", [5, 16, 17])
@pytest.mark.parametrize("c", [1, 16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b4_bit_exact_vs_plain(dtype):
    dev = gpu_device()
    g = torch.Generator(device="cpu").manual_seed(8)
    kp = torch.randn(9, 16, 8, 128, generator=g).to(dev, dtype)
    vp = torch.randn(9, 16, 8, 128, generator=g).to(dev, dtype)
    nk = torch.randn(4, 1, 8, 128, generator=g).to(dev)
    nv = torch.randn(4, 1, 8, 128, generator=g).to(dev)
    flat = torch.tensor([[17], [0], [40], [143]], device=dev)
    k2, v2, k3, v3 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    pa.fused_write_call(k2, v2, nk, nv, flat)
    pa.fused_write_plain(k3, v3, nk, nv, flat)
    assert torch.equal(k2, k3) and torch.equal(v2, v3)
    assert torch.equal(k2[0], kp[0])       # flat 0: no write
