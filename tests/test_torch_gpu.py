"""The port's Hopper kernels against their plain PyTorch versions, on the
card (marker `gpu`; each test skips without a CUDA device). Run there with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

B1, B2, B4, B5 and B6 must be bit-exact (B5/B6 at NOISY and at FULL: the
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
