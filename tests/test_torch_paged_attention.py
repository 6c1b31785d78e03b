"""Kernels B3/B4 and the attention registry: the port against the
reference.

The plain B3 runs the kernel's split-KV online softmax in f32 (each of
S = min(8, MB) ranks over its own table columns, then the ranks combined
in rank order) with another summation order than the Pallas kernel, so it
is held within atol/rtol 2e-5 (f32 rounding over windows of <= 136
positions of unit-scale scores);
the "exact" backend likewise against the reference "exact". Every case
uses mixed lengths, an idle lane and a NaN-filled trash block, and the
outputs must be finite. Head dims and block sizes past the kernel's fast
case (dh 16, 20, 56, 80; bs 48, 64, 128, which B3 scores in pieces of 32
tokens) are held likewise. The plain B4 is bit-exact. The decode entry (B4's
write folded into B3's launch on the card; on CPU tensors the plain
pair) is held against the reference's fused write then flash attention:
pools bit-exact, outputs within TOL. Inputs come from numpy seeds; the
card-side tests are in test_torch_gpu.py.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_attention as ref_pa  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import common, registry, transformer  # noqa: E402

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


# (head dim, block size, table width): dh not a multiple of 32 (bf16 rows
# of dh 20 are 40 bytes), blocks of more than 32 tokens
C1_SHAPES = [(16, 8, 5), (20, 16, 5), (56, 16, 4), (80, 16, 5), (32, 48, 3),
             (32, 64, 3), (80, 128, 2)]


@pytest.mark.parametrize("c", [1, 5, 16])
@pytest.mark.parametrize("dh,bs,mb", C1_SHAPES)
def test_plain_b3_any_head_dim_and_block_size_vs_pallas(dh, bs, mb, c):
    q, kp, vp, tables, lens, kvl = case = _case(c + dh, c=c, mb=mb, dh=dh,
                                               bs=bs)
    ref = np.asarray(ref_pa.paged_flash_attention(
        *(jnp.asarray(a) for a in case), interpret=True, kblocks=1,
        row_tile=None))
    out = pa.paged_attn_call(*_torch(case)).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.all(out[0] == 0.0)


@pytest.mark.parametrize("dh,bs,mb", C1_SHAPES)
def test_plain_b4_any_head_dim_and_block_size_vs_fused_write(dh, bs, mb):
    """The write at every shape, bit-exact against the reference's fused
    write (lane 0 idle, the others at offsets 0, bs - 1 and mid-block)."""
    rng = np.random.RandomState(dh + bs)
    nb = 4 * mb + 1
    kp = rng.standard_normal((nb, bs, 2, dh)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, 2, dh)).astype(np.float32)
    nk = rng.standard_normal((4, 1, 2, dh)).astype(np.float32)
    nv = rng.standard_normal((4, 1, 2, dh)).astype(np.float32)
    flat = np.array([[0], [3 * bs], [5 * bs - 1], [7 * bs + bs // 2]],
                    np.int32)
    rk, rv = ref_pa.fused_paged_write(jnp.asarray(kp), jnp.asarray(vp),
                                      jnp.asarray(nk), jnp.asarray(nv),
                                      jnp.asarray(flat), interpret=True)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    pa.fused_write_plain(tk, tv, torch.from_numpy(nk), torch.from_numpy(nv),
                         torch.from_numpy(flat))
    assert np.array_equal(np.asarray(rk), tk.numpy())
    assert np.array_equal(np.asarray(rv), tv.numpy())
    assert np.array_equal(tk[0].numpy(), kp[0])


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
    """B4 through the decode entry: pools bit-exact against the reference's
    fused write, written in place, the invalid lane (flat 0) writing
    nothing."""
    rng = np.random.RandomState(4)
    nb, bs, kh, dh = 9, 8, 2, 32
    kp = rng.standard_normal((nb, bs, kh, dh)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, kh, dh)).astype(np.float32)
    nk = rng.standard_normal((4, 1, kh, dh)).astype(np.float32)
    nv = rng.standard_normal((4, 1, kh, dh)).astype(np.float32)
    q = rng.standard_normal((4, 1, 2 * kh, dh)).astype(np.float32)
    flat = np.array([[13], [0], [40], [71]], np.int32)   # lane 1 invalid
    # each lane's table maps the block its write lands in at its position
    tables = np.array([[1, 0], [0, 0], [4, 5], [7, 8]], np.int32)
    lens = np.array([5, 0, 8, 15], np.int32)
    kvl = lens + np.array([1, 0, 1, 1], np.int32)
    rk, rv = ref_pa.fused_paged_write(jnp.asarray(kp), jnp.asarray(vp),
                                      jnp.asarray(nk), jnp.asarray(nv),
                                      jnp.asarray(flat), interpret=True)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = pa.decode_write_attend_call(
        torch.from_numpy(q), tk, tv, torch.from_numpy(nk),
        torch.from_numpy(nv), torch.from_numpy(flat),
        *(torch.from_numpy(a) for a in (tables, lens, kvl)))
    assert out.shape == (4, 1, 2 * kh, dh) and out.dtype == torch.float32
    assert np.array_equal(np.asarray(rk), tk.numpy())   # written in place
    assert np.array_equal(np.asarray(rv), tv.numpy())
    assert np.array_equal(tk[0].numpy(), kp[0])      # trash block untouched


# The decode entry's cases, by table width MB (S = min(8, MB) split ranks
# of B3): the table column of the write of slots 1-3 (slot 0 is idle:
# flat 0, kv_len 0). Slot 1 writes at offset bs - 1, slot 2 opens a new
# block (offset 0), slot 3 writes mid-block. At MB 5 (5 ranks of 1
# column) and MB 17 (8 ranks of 3) every write block is owned by a rank
# > 0: columns 2, 4, 1 (ranks 2, 4, 1) and 7, 16, 10 (ranks 2, 5, 3).
DECODE_WRITES = {1: (0, 0, 0), 5: (2, 4, 1), 17: (7, 16, 10)}


@functools.lru_cache(maxsize=None)
def _decode_case(mb, seed=9, b=4, kh=2, g=2, dh=32, bs=8):
    """Numpy inputs of one decode write + attend, and the reference's
    pools and output (fused_paged_write, then paged_flash_attention in
    interpret mode)."""
    rng = np.random.RandomState(seed + mb)
    nb = b * mb + 1
    q = rng.standard_normal((b, 1, kh * g, dh)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, kh, dh)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, kh, dh)).astype(np.float32)
    nk = rng.standard_normal((b, 1, kh, dh)).astype(np.float32)
    nv = rng.standard_normal((b, 1, kh, dh)).astype(np.float32)
    kp[0] = np.nan
    vp[0] = np.nan
    free = list(range(1, nb))
    rng.shuffle(free)
    tables = np.zeros((b, mb), np.int32)
    lens = np.zeros(b, np.int32)
    flat = np.zeros((b, 1), np.int32)
    for s, (col, off) in enumerate(zip(DECODE_WRITES[mb],
                                       (bs - 1, 0, 3)), start=1):
        for j in range(col + 1):
            tables[s, j] = free.pop()
        lens[s] = col * bs + off
        flat[s, 0] = tables[s, col] * bs + off
    kvl = lens + np.array([0] + [1] * (b - 1), np.int32)
    rk, rv = ref_pa.fused_paged_write(jnp.asarray(kp), jnp.asarray(vp),
                                      jnp.asarray(nk), jnp.asarray(nv),
                                      jnp.asarray(flat), interpret=True)
    ref = ref_pa.paged_flash_attention(
        jnp.asarray(q), rk, rv, jnp.asarray(tables), jnp.asarray(lens),
        jnp.asarray(kvl), interpret=True, kblocks=1, row_tile=None)
    inputs = (q, kp, vp, nk, nv, flat, tables, lens, kvl)
    return inputs, (np.asarray(rk), np.asarray(rv), np.asarray(ref))


@pytest.mark.parametrize("backend", ["kernel", "plain"])
@pytest.mark.parametrize("mb", sorted(DECODE_WRITES))
def test_decode_entry_vs_reference_write_then_attend(mb, backend):
    (q, kp, vp, nk, nv, flat, tables, lens, kvl), (rk, rv, ref) = \
        _decode_case(mb)
    per = pa.attn_splits(mb)[1]
    assert mb == 1 or min(col // per for col in DECODE_WRITES[mb]) > 0
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = pa.get_attn_backend(backend).decode_write_attend(
        torch.from_numpy(q), tk, tv,
        *(torch.from_numpy(a) for a in (nk, nv, flat, tables, lens, kvl)))
    assert np.array_equal(tk.numpy(), rk, equal_nan=True)
    assert np.array_equal(tv.numpy(), rv, equal_nan=True)
    assert np.isnan(tk[0].numpy()).all()             # idle lane: no write
    out = out.numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.all(out[0] == 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_paged_step_decode_entry_same_as_write_then_attend(backend, dtype,
                                                            monkeypatch):
    """A decode step (C = 1) through the backend's decode entry gives the
    same logits and pools as through paged_write + paged_attention (the
    entry removed from the registry); only the trash block differs, where
    paged_write parks the idle lane's row."""
    cfg = SMOKES["internlm2-1.8b"].replace(dtype=dtype, attn_backend=backend)
    params = registry.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(11)
    tables = torch.tensor([[0, 0, 0], [1, 2, 3], [4, 5, 0], [6, 0, 0]],
                          dtype=torch.int32)
    cache = transformer.init_paged_cache(cfg, 7, 4, device="cpu")
    _, cache = transformer.paged_step(
        params, torch.from_numpy(rng.randint(0, cfg.vocab, (4, 6))), cache,
        tables, torch.zeros(4, dtype=torch.int32),
        torch.tensor([0, 6, 6, 3], dtype=torch.int32), cfg)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 1)))
    lens = torch.tensor([0, 6, 6, 3], dtype=torch.int32)
    valid = torch.tensor([0, 1, 1, 1], dtype=torch.int32)
    runs = []
    for entry in (True, False):
        if not entry:
            spec = dataclasses.replace(pa.get_attn_backend(backend),
                                       decode_write_attend=None)
            monkeypatch.setitem(pa._ATTN_REGISTRY, backend, spec)
        c = {"layers": {k: v.clone() for k, v in cache["layers"].items()}}
        logits, c = transformer.paged_step(params, tok, c, tables, lens,
                                           valid, cfg)
        runs.append((logits, c["layers"]))
    (l_e, p_e), (l_w, p_w) = runs
    assert torch.isfinite(l_e[1:]).all()
    assert torch.equal(l_e, l_w)
    for name in ("k", "v"):
        assert torch.equal(p_e[name][:, 1:], p_w[name][:, 1:])
        assert torch.equal(p_e[name][:, 0], cache["layers"][name][:, 0])


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
    assert pa.get_attn_backend("kernel").decode_write_attend is not None
    assert pa.get_attn_backend("plain").decode_write_attend is not None
    assert pa.get_attn_backend("exact").decode_write_attend is None
    with pytest.raises(ValueError, match="unknown attention backend"):
        pa.choose_attn_backend("nope")


def test_cpu_calls_launch_nothing():
    case = _torch(_case(6))
    before = (pa.paged_attn_call.launches,
              pa.decode_write_attend_call.launches)
    pa.paged_attn_call(*case)
    q, kp, vp, tables, lens, kvl = case
    new = torch.zeros(q.shape[0], 1, kp.shape[2], kp.shape[3])
    pa.decode_write_attend_call(q, kp, vp, new, new,
                                torch.zeros(q.shape[0], dtype=torch.int32),
                                tables, lens, kvl)
    assert (pa.paged_attn_call.launches,
            pa.decode_write_attend_call.launches) == before


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
