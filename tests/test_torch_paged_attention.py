"""Kernels B3/B4 and the attention registry: the port against the
reference.

The plain B3 runs the kernel's split-KV online softmax in f32 (each of
S = min(8, MB) ranks over its own table columns, then the ranks combined
in rank order) with another summation order than the Pallas kernel, so it
is held within atol/rtol 2e-5 (f32 rounding over windows of <= 136
positions of unit-scale scores);
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


def _case(seed, *, b=4, kh=2, g=2, dh=32, bs=8, mb=5, c=1, kv_ends=None):
    """Pool + tables + mixed per-slot depths, lane 0 idle, trash block NaN.
    `kv_ends` fixes kv_len of slots 1.. (random otherwise). Returns numpy
    arrays (q, kp, vp, tables, lens, kv_len)."""
    rng = np.random.RandomState(seed)
    w = mb * bs
    nb = b * mb + 1
    q = rng.standard_normal((b, c, kh * g, dh)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, kh, dh)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, kh, dh)).astype(np.float32)
    kp[0] = np.nan
    vp[0] = np.nan
    valid = np.array([0] + [c] * (b - 1))
    if kv_ends is None:
        lens = np.array([0] + [rng.randint(0, w - c + 1)
                               for _ in range(b - 1)])
    else:
        lens = np.array([0] + list(kv_ends)) - valid
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


# How each case lays kv_len over the S = min(8, MB) split ranks of B3
# (table width, kv_len of slots 1-3 at block size 8; slot 0 is idle):
LAYOUTS = {
    # MB 5 or 6 (S = MB, one column per rank), random depths
    "mixed": None,
    # MB 16: S = 8 ranks of 2 columns; kv_len 16 and 48 end exactly on a
    # split boundary, so ranks 1-7 (and 3-7) read nothing
    "split-boundary": (16, (16, 48, 128)),
    # MB 17 is no multiple of S = 8: ranks of 3 columns, rank 5 holds 2
    # and ranks 6-7 lie wholly past the table; kv_len 24 ends on a boundary
    "ragged-splits": (17, (77, 24, 136)),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("c", [1, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_b3_vs_pallas_interpret(c, seed, layout):
    if LAYOUTS[layout] is None:
        mb, kv_ends = (5 if c == 1 else 6), None
    else:
        mb, kv_ends = LAYOUTS[layout]
    q, kp, vp, tables, lens, kvl = case = _case(seed, c=c, mb=mb,
                                               kv_ends=kv_ends)
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


@pytest.mark.parametrize("mb,splits", [(1, (1, 1)), (5, (5, 1)),
                                       (16, (8, 2)), (17, (8, 3))])
def test_attn_splits(mb, splits):
    """S = min(8, MB) ranks of ceil(MB / S) table columns each."""
    assert pa.attn_splits(mb) == splits


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


if __name__ == "__main__":
    # the measured distance behind TOL: plain B3 against the Pallas kernel
    # in interpret mode over the cases of test_plain_b3_vs_pallas_interpret
    worst = 0.0
    for name, spec in sorted(LAYOUTS.items()):
        for c in (1, 16):
            for seed in (0, 1):
                mb, ends = ((5 if c == 1 else 6), None) if spec is None \
                    else spec
                case = _case(seed, c=c, mb=mb, kv_ends=ends)
                ref = np.asarray(ref_pa.paged_flash_attention(
                    *(jnp.asarray(a) for a in case), interpret=True,
                    kblocks=1, row_tile=None))
                out = pa.paged_attn_call(*_torch(case)).numpy()
                worst = max(worst, float(np.abs(out - ref).max()))
    print(f"plain B3 vs Pallas interpret: max |diff| {worst:.3g} "
          f"(TOL {TOL['atol']})")
