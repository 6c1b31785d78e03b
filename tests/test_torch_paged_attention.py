"""Kernels B3/B4 and the attention registry: the port against the
reference.

The plain B3 runs the kernel's online softmax in f32 with another
summation order than the Pallas kernel, so it is held within atol/rtol
2e-5 (f32 rounding over windows of <= 80 positions of unit-scale scores);
the "exact" backend likewise against the reference "exact". Every case
uses mixed lengths, an idle lane and a NaN-filled trash block, and the
outputs must be finite. The plain B4 is bit-exact. Inputs come from numpy
seeds; the card-side tests are in test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_attention as ref_pa  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import common  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _case(seed, *, b=4, kh=2, g=2, dh=32, bs=8, mb=5, c=1):
    """Pool + tables + mixed per-slot depths, lane 0 idle, trash block NaN.
    Returns numpy arrays (q, kp, vp, tables, lens, kv_len)."""
    rng = np.random.RandomState(seed)
    w = mb * bs
    nb = b * mb + 1
    q = rng.standard_normal((b, c, kh * g, dh)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, kh, dh)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, kh, dh)).astype(np.float32)
    kp[0] = np.nan
    vp[0] = np.nan
    lens = np.array([0] + [rng.randint(0, w - c + 1) for _ in range(b - 1)])
    valid = np.array([0] + [c] * (b - 1))
    kvl = lens + valid
    free = list(range(1, nb))
    rng.shuffle(free)
    tables = np.zeros((b, mb), np.int32)
    for s in range(b):
        for j in range(-(-int(kvl[s]) // bs)):
            tables[s, j] = free.pop()
    return (q, kp, vp, tables, lens.astype(np.int32), kvl.astype(np.int32))


def _torch(case):
    return tuple(torch.from_numpy(np.array(a)) for a in case)


def _positions(lens, c):
    return lens[:, None] + np.arange(c, dtype=np.int32)[None, :]


@pytest.mark.parametrize("c", [1, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_b3_vs_pallas_interpret(c, seed):
    q, kp, vp, tables, lens, kvl = case = _case(seed, c=c,
                                               mb=5 if c == 1 else 6)
    ref = np.asarray(ref_pa.paged_flash_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(kvl),
        interpret=True, kblocks=1, row_tile=None))
    out = pa.paged_attn_call(*_torch(case)).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.all(out[0] == 0.0)     # idle lane emits exactly 0


@pytest.mark.parametrize("c", [1, 16])
def test_exact_backend_vs_reference(c):
    q, kp, vp, tables, lens, kvl = case = _case(2, c=c, mb=6)
    pos = _positions(lens, c)
    ref = np.asarray(ref_pa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), positions=jnp.asarray(pos),
        kv_len=jnp.asarray(kvl), backend="exact"))
    tq, tk, tv, tt, _, tkvl = _torch(case)
    out = pa.paged_attention(tq, tk, tv, tt, positions=torch.from_numpy(pos),
                             kv_len=tkvl, backend="exact").numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("c", [1, 5])
def test_kernel_and_plain_backends_agree_with_exact(c):
    q, kp, vp, tables, lens, kvl = case = _case(3, c=c)
    tq, tk, tv, tt, _, tkvl = _torch(case)
    pos = torch.from_numpy(_positions(lens, c))
    outs = {name: pa.paged_attention(tq, tk, tv, tt, positions=pos,
                                     kv_len=tkvl, backend=name).numpy()
            for name in ("exact", "kernel", "plain")}
    assert np.array_equal(outs["kernel"], outs["plain"])
    np.testing.assert_allclose(outs["kernel"], outs["exact"], **TOL)


def test_plain_b4_bit_exact_vs_fused_write():
    rng = np.random.RandomState(4)
    nb, bs, kh, dh = 9, 8, 2, 16
    kp = rng.standard_normal((nb, bs, kh, dh)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, kh, dh)).astype(np.float32)
    nk = rng.standard_normal((4, 1, kh, dh)).astype(np.float32)
    nv = rng.standard_normal((4, 1, kh, dh)).astype(np.float32)
    flat = np.array([[13], [0], [40], [71]], np.int32)   # lane 1 invalid
    rk, rv = ref_pa.fused_paged_write(jnp.asarray(kp), jnp.asarray(vp),
                                      jnp.asarray(nk), jnp.asarray(nv),
                                      jnp.asarray(flat), interpret=True)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    ok, ov = pa.fused_write_call(tk, tv, torch.from_numpy(nk),
                                  torch.from_numpy(nv), torch.from_numpy(flat))
    assert ok is tk and ov is tv                     # written in place
    assert np.array_equal(np.asarray(rk), tk.numpy())
    assert np.array_equal(np.asarray(rv), tv.numpy())
    assert np.array_equal(tk[0].numpy(), kp[0])      # trash block untouched


def test_paged_write_and_gather_vs_reference():
    rng = np.random.RandomState(5)
    pool = rng.standard_normal((7, 4, 2, 8)).astype(np.float32)
    new = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    flat = np.array([[5, 6, 0], [9, 0, 0]], np.int32)
    ref = np.asarray(ref_common.paged_write(jnp.asarray(pool),
                                            jnp.asarray(new),
                                            jnp.asarray(flat)))
    tp = torch.from_numpy(pool.copy())
    common.paged_write(tp, torch.from_numpy(new), torch.from_numpy(flat))
    # row 0 of the trash block takes one of the duplicate masked writes
    assert np.array_equal(ref[1:], tp.numpy()[1:])
    tables = np.array([[2, 0], [1, 3]], np.int32)
    assert np.array_equal(
        np.asarray(ref_common.paged_gather(jnp.asarray(ref),
                                           jnp.asarray(tables)))[:, 4:],
        common.paged_gather(tp, torch.from_numpy(tables)).numpy()[:, 4:])


def test_registry():
    assert set(pa.available_attn_backends()) == {"exact", "kernel", "plain"}
    assert pa.choose_attn_backend("auto") == "kernel"
    assert pa.get_attn_backend("kernel").fused_write is not None
    assert pa.get_attn_backend("exact").fused_write is None
    with pytest.raises(ValueError, match="unknown attention backend"):
        pa.choose_attn_backend("nope")


def test_cpu_calls_launch_nothing():
    case = _torch(_case(6))
    before = (pa.paged_attn_call.launches, pa.fused_write_call.launches)
    pa.paged_attn_call(*case)
    assert (pa.paged_attn_call.launches,
            pa.fused_write_call.launches) == before
