"""The seeded stochastic converter path (kernels B5/B6, ROADMAP A6): the
port against the reference.

  * The counter hash (`_mix32`, `salt_seed`, `_counter_base`,
    `_normal12`) is bit-exact against the reference's on uint32 edge
    values.
  * The plain B5 and B6 are BIT-EXACT against the Pallas kernels in
    interpret mode at NOISY (tolerance 0), whatever the reference's tiles:
    the draw is a pure function of (seed, global row, global column,
    group), and XLA's fused multiply-adds are reproduced exactly.
  * FULL adds the INL curve, which calls sin, and XLA's f32 sin and
    torch's differ in the last bit for some arguments. Measured effect
    (`python tests/test_torch_noisy.py`, the measurements at the end of
    this file): 0 differing outputs of 1,048,576 (two 512 x 5760 x 1024
    MVMs, 42 M conversions); so FULL_TOL allows one differing output per
    MVM, by exactly one ADC step. `inl_curve` itself agrees with the
    jitted reference to INL_ATOL LSB (measured 2.4e-7, two f32 ulps, over
    200,001 code fractions and three instances).
  * Engine contracts follow tests/test_engine.py: auto routing, seeded
    reproducibility, the inl_seed salt, the ValueErrors, and the eager
    backends' distribution against the kernel (their draws come from
    torch.Generator, so they agree in distribution only).
Inputs come from numpy seeds. The card-side tests are in test_torch_gpu.py.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.adc import inl_curve as ref_inl_curve  # noqa: E402
from repro.core.macro import MacroConfig as RefMacro  # noqa: E402
from repro.core.macro import SimLevel as RefLevel  # noqa: E402
from repro.kernels import cim_mvm as ref_km  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.adc import inl_curve  # noqa: E402
from repro_torch.core.cim_matmul import (CIMConfig, cim_matmul,  # noqa: E402
                                         cim_matmul_prequant,
                                         quantize_weight_offline)
from repro_torch.core.macro import MacroConfig, SimLevel  # noqa: E402
from repro_torch.kernels import cim_mvm, ops  # noqa: E402

ref_cim = importlib.import_module("repro.core.cim_matmul")
LSB = np.float32(32400.0 / 361)       # default macro: full scale / (L - 1)
FULL_TOL = (1, 1)                     # outputs that may differ, ADC steps
INL_ATOL = 5e-7                       # LSB


def _codes(seed, shape):
    return np.random.RandomState(seed).randint(0, 16, shape) \
        .astype(np.float32)


def _act(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _macros(level):
    return (RefMacro(sim_level=RefLevel(level)),
            MacroConfig(sim_level=SimLevel(level)))


def _cfgs(level="noisy", seed=0, backend="auto"):
    rmac, tmac = _macros(level)
    return (ref_cim.CIMConfig(enabled=True, macro=rmac, noise_seed=seed),
            CIMConfig(enabled=True, macro=tmac, noise_seed=seed,
                      backend=backend))


def _seed(s):
    return torch.tensor([s], dtype=torch.int32)


# ---------------------------------------------------------------------------
# the counter hash
# ---------------------------------------------------------------------------
EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
                  0xFFFFFFFF, 0x9E3779B9, 12345], dtype=np.uint32)


def _u32(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def test_mix32_bit_exact():
    vals = np.concatenate([EDGES, np.random.RandomState(0).randint(
        0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)])
    ref = np.asarray(ref_km._mix32(jnp.asarray(vals)))
    assert np.array_equal(cim_mvm._mix32(_u32(vals)).numpy(),
                          ref.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, -1, 2**31 - 1])
@pytest.mark.parametrize("salt", [0, 3, -5])
def test_salt_seed_and_counter_base_bit_exact(seed, salt):
    salted = np.asarray(ref_km.salt_seed(seed, salt))
    port = cim_mvm.salt_seed(seed, salt)
    assert port.dtype == torch.int32 and int(port) == int(salted)
    if salt == 0:
        assert int(port) == seed
    rows = np.arange(0, 40, dtype=np.int32)[:, None]
    cols = np.array([0, 1, 5, 127, 128, 92543], dtype=np.int32)[None, :]
    for group in (0, 1, 56):
        ref = np.asarray(ref_km._counter_base(
            jnp.asarray(salted, jnp.int32), jnp.asarray(rows),
            jnp.asarray(cols), jnp.asarray(group, jnp.int32)))
        got = cim_mvm._counter_base(
            port.to(torch.int64) & 0xFFFFFFFF, torch.from_numpy(rows).long(),
            torch.from_numpy(cols).long(), group)
        assert np.array_equal(got.numpy(), ref.astype(np.int64))


def test_normal12_bit_exact():
    base = np.concatenate([EDGES, np.random.RandomState(1).randint(
        0, 2**32, 8192, dtype=np.uint64).astype(np.uint32)])
    ref = np.asarray(ref_km._normal12(jnp.asarray(base)))
    got = cim_mvm._normal12(_u32(base)).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, ref)


def test_fma_f32_rounds_once():
    """fma_f32 against exact rational arithmetic, including sums that a
    float64 add rounds onto an f32 tie (double rounding would then pick
    the even neighbour, 1 + 2^-22, instead of 1 + 2^-23)."""
    from fractions import Fraction
    from repro_torch.core.adc import fma_f32
    rng = np.random.RandomState(5)
    a = np.concatenate([[2.0**-24 * (1 + 2.0**-23)] * 2,
                        rng.standard_normal(2000)]).astype(np.float32)
    b = np.concatenate([[1 - 2.0**-23, 1 + 2.0**-23],
                        rng.standard_normal(2000)]).astype(np.float32)
    c = np.concatenate([[1 + 2.0**-23, 1.0],
                        rng.standard_normal(2000) * 300]).astype(np.float32)
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    assert got[0] == got[1] == np.float32(1 + 2.0**-23)
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        near = [np.nextafter(got[i], np.float32(d)) for d in (-np.inf,
                                                               np.inf)]
        err = abs(Fraction(float(got[i])) - exact)
        assert all(err <= abs(Fraction(float(v)) - exact) for v in near)


# ---------------------------------------------------------------------------
# B5 / B6 plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
def _ref_b5(x, w, mac, seed, inl_seed, **tiles):
    return np.asarray(ref_ops.cim_mvm_pallas_noisy(
        jnp.asarray(x), jnp.asarray(w), mac, noise_seed=seed,
        inl_seed=inl_seed, interpret=True, **tiles))


def _ref_b6(x, wp, mac, seed, inl_seed):
    return np.asarray(ref_ops.cim_mvm_pallas_noisy_packed(
        jnp.asarray(x), jnp.asarray(wp), mac, noise_seed=seed,
        inl_seed=inl_seed, interpret=True))


@pytest.mark.parametrize("n", [24, 130])
@pytest.mark.parametrize("k", [144, 288, 433])
@pytest.mark.parametrize("m", [1, 4, 16])
def test_plain_b5_bit_exact_vs_pallas(m, k, n):
    x, w = _codes(m + k, (m, k)), _codes(n + k, (k, n))
    rmac, tmac = _macros("noisy")
    for inl_seed in (0, 3):
        for seed in (0, 7):
            yr = _ref_b5(x, w, rmac, seed, inl_seed)
            yt = ops.cim_mvm_noisy(torch.from_numpy(x), torch.from_numpy(w),
                                   tmac, noise_seed=_seed(seed),
                                   inl_seed=inl_seed).numpy()
            assert np.array_equal(yr, yt), (seed, inl_seed)
    if m == 16:
        # other reference tiles: 2 row tiles, N padded to 16-column tiles
        yr = _ref_b5(x, w, rmac, 7, 3, bm=8, bn=16)
        assert np.array_equal(yr, yt)


@pytest.mark.parametrize("n_rows,m,k,n", [
    (9, 4, 100, 40), (9, 64, 90, 20), (145, 4, 300, 33), (145, 64, 200, 18),
    (1024, 4, 2100, 24), (1024, 64, 1500, 17)])
def test_plain_b5_bit_exact_vs_pallas_other_depths(n_rows, m, k, n):
    """Macro depths other than 144 (odd, one past it, and deep groups);
    B6 equals B5 at the even depth."""
    x, w = _codes(m + k + 1, (m, k)), _codes(n + k + 1, (k, n))
    rmac = RefMacro(n_rows=n_rows, sim_level=RefLevel.NOISY)
    tmac = MacroConfig(n_rows=n_rows, sim_level=SimLevel.NOISY)
    for inl_seed, seed in ((0, 0), (3, 7)):
        yr = _ref_b5(x, w, rmac, seed, inl_seed)
        yt = ops.cim_mvm_noisy(torch.from_numpy(x), torch.from_numpy(w),
                               tmac, noise_seed=_seed(seed),
                               inl_seed=inl_seed).numpy()
        assert np.array_equal(yr, yt), (seed, inl_seed)
        if n_rows % 2 == 0:
            y6 = ops.cim_mvm_noisy_packed(
                torch.from_numpy(x), ops.pack_codes(torch.from_numpy(w)),
                tmac, noise_seed=_seed(seed), inl_seed=inl_seed).numpy()
            assert np.array_equal(y6, yt), (seed, inl_seed)


@pytest.mark.parametrize("n", [24, 130])
@pytest.mark.parametrize("k", [288, 433])
@pytest.mark.parametrize("m", [4, 16])
def test_plain_b6_bit_exact_vs_pallas_and_b5(m, k, n):
    x, w = _codes(m + 2 * k, (m, k)), _codes(n + 2 * k, (k, n))
    wp = ops.pack_codes(torch.from_numpy(w))
    rmac, tmac = _macros("noisy")
    for inl_seed, seed in ((0, 0), (3, 7)):
        yr = _ref_b6(x, wp.numpy(), rmac, seed, inl_seed)
        yt = ops.cim_mvm_noisy_packed(torch.from_numpy(x), wp, tmac,
                                      noise_seed=_seed(seed),
                                      inl_seed=inl_seed)
        assert np.array_equal(yr, yt.numpy()), (seed, inl_seed)
        y5 = ops.cim_mvm_noisy(torch.from_numpy(x), torch.from_numpy(w),
                               tmac, noise_seed=_seed(seed),
                               inl_seed=inl_seed)
        assert torch.equal(yt, y5)


def _crafted_tie(seed, m, n, part, shape=(8, 128)):
    """x [M, 144], w [144, N] whose MAC at (m, n) is `part` (x row m is 15s
    and one remainder code; w column n sums to part // 15)."""
    x = np.zeros((shape[0], 144), np.float32)
    w = np.zeros((144, shape[1]), np.float32)
    s15, d = divmod(part, 15)
    x[m, :143], x[m, 143] = 15, d
    q, r = divmod(s15, 15)
    w[:q, n] = 15
    if q < 143:
        w[q, n] = r
    w[143, n] = 1
    return x, w


def _separate_add_code(seed, m, n, part):
    """The ADC code of conversion (m, n, group 0) if x + σ·n were a
    multiply then an add (not what the reference computes)."""
    salted = cim_mvm.salt_seed(seed, 0).to(torch.int64) & 0xFFFFFFFF
    base = cim_mvm._counter_base(salted, torch.tensor(m), torch.tensor(n), 0)
    nz = cim_mvm._normal12(base.reshape(1)).numpy()[0]
    _, inv_lsb = cim_mvm.adc_constants(362, 1.0, 32400.0)
    x = np.float32(np.float32(part) * np.float32(inv_lsb))
    return float(np.round(np.float32(x + np.float32(np.float32(0.277) * nz))))


# (seed, row, column, MAC) where fma(σ, n, x) and a separate multiply and
# add round to different ADC codes (found by search; see __main__ below)
TIES = [(0, 6, 50, 22319), (11, 6, 124, 238), (15, 5, 104, 16446),
        (21, 6, 127, 18294), (23, 0, 48, 17899), (27, 5, 102, 11737)]


@pytest.mark.parametrize("seed,m,n,part", TIES)
def test_noisy_transfer_fuses_like_xla(seed, m, n, part):
    """The reference computes x + σ·n as one fused multiply-add: on inputs
    crafted so that a separate multiply and add would round to another
    code, the plain B5 still equals the reference."""
    x, w = _crafted_tie(seed, m, n, part)
    rmac, tmac = _macros("noisy")
    yr = _ref_b5(x, w, rmac, seed, 0)
    yt = ops.cim_mvm_noisy(torch.from_numpy(x), torch.from_numpy(w), tmac,
                           noise_seed=_seed(seed)).numpy()
    assert np.array_equal(yr, yt)
    assert round(float(yr[m, n] / LSB)) != _separate_add_code(seed, m, n,
                                                              part)


# ---------------------------------------------------------------------------
# FULL: the INL curve
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("inl_seed", [0, 3, 11])
def test_inl_curve_vs_reference(inl_seed):
    cf = np.linspace(0.0, 1.0, 200001).astype(np.float32)
    ref = np.asarray(jax.jit(lambda c: ref_inl_curve(c, 1.1, inl_seed))(
        jnp.asarray(cf)))
    got = inl_curve(torch.from_numpy(cf), 1.1, inl_seed).numpy()
    assert got.dtype == np.float32
    assert np.max(np.abs(got - ref)) <= INL_ATOL
    assert np.max(np.abs(ref)) <= 1.1


# At 128 x 1440 x 512, seed 7, INL instance 3 the code fraction computed as
# written, (part * inv_lsb) / L, moves 7 outputs from the reference's (which
# folds the constants; measured at the end of this file), so FULL_TOL also
# guards that fold.
@pytest.mark.parametrize("m,k,n,inl_seed", [(16, 433, 130, 0),
                                            (128, 1440, 512, 3)])
def test_plain_b5_full_vs_pallas(m, k, n, inl_seed):
    x, w = _codes(m, (m, k)), _codes(n, (k, n))
    rmac, tmac = _macros("full")
    yr = _ref_b5(x, w, rmac, 7, inl_seed)
    yt = ops.cim_mvm_noisy(torch.from_numpy(x), torch.from_numpy(w), tmac,
                           noise_seed=_seed(7), inl_seed=inl_seed).numpy()
    diff = yt != yr
    assert int(diff.sum()) <= FULL_TOL[0]
    steps = np.abs(yt[diff] - yr[diff]) / LSB
    assert np.all(np.abs(steps - np.round(steps)) < 1e-3)
    assert np.all(steps <= FULL_TOL[1] + 1e-3)


# ---------------------------------------------------------------------------
# engine contracts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("level", ["noisy", "full"])
def test_auto_routes_seeded_stochastic_to_kernels(level):
    _, cfg = _cfgs(level)
    x, w = torch.zeros(8, 300), torch.zeros(300, 10)
    packed = engine.PackedCodes(ops.pack_codes(w), 300)
    assert engine.choose_backend(cfg, x, w) == "cuda_noisy"
    assert engine.choose_backend(cfg, x, packed) == "cuda_noisy_packed"
    noseed = dataclasses.replace(cfg, noise_seed=None)
    assert engine.choose_backend(noseed, x, w) == "einsum"
    assert engine.choose_backend(noseed, x, packed) == "einsum"
    # 30 groups x 4096 rows x 4096 columns of pre-ADC f32 >> 64 MB
    big_x = torch.empty(4096, 4320, device="meta")
    big_w = torch.empty(4320, 4096, device="meta")
    assert engine.choose_backend(noseed, big_x, big_w) == "scan"


def test_kernel_path_reproducible_and_salted():
    _, cfg = _cfgs(seed=7)
    x = torch.from_numpy(np.maximum(_act(22, (16, 430)), 0))
    w = torch.from_numpy(_act(23, (430, 24), 0.1))
    y1, y2 = cim_matmul(x, w, cfg), cim_matmul(x, w, cfg)
    assert torch.equal(y1, y2) and torch.isfinite(y1).all()
    assert not torch.equal(y1, cim_matmul(
        x, w, dataclasses.replace(cfg, noise_seed=8)))
    for backend in ("cuda_noisy", "einsum", "scan"):
        c = dataclasses.replace(cfg, backend=backend)
        ya, yb = cim_matmul(x, w, c, inl_seed=0), cim_matmul(x, w, c,
                                                             inl_seed=1)
        assert torch.equal(ya, cim_matmul(x, w, c, inl_seed=0)), backend
        assert not torch.equal(ya, yb), backend


def test_eager_backends_seeded_reproducible():
    _, cfg = _cfgs(seed=11)
    x = torch.from_numpy(np.maximum(_act(25, (8, 430)), 0))
    w = torch.from_numpy(_act(26, (430, 10), 0.1))
    for backend in ("einsum", "scan"):
        c = dataclasses.replace(cfg, backend=backend)
        assert torch.equal(cim_matmul(x, w, c), cim_matmul(x, w, c))
        assert not torch.equal(cim_matmul(x, w, c), cim_matmul(
            x, w, dataclasses.replace(c, noise_seed=12)))


def test_stochastic_kernel_rejects_ideal_and_needs_seed():
    x, w = torch.ones(4, 300), torch.ones(300, 10)
    with pytest.raises(ValueError, match="stochastic"):
        cim_matmul(x, w, CIMConfig(enabled=True, backend="cuda_noisy"))
    _, noseed = _cfgs(seed=None, backend="cuda_noisy")
    with pytest.raises(ValueError, match="noise_seed"):
        cim_matmul(x, w, noseed)
    _, det = _cfgs(backend="cuda")
    with pytest.raises(ValueError, match="deterministic"):
        cim_matmul(x, w, det)
    # a torch.Generator key alone seeds the kernel from its initial seed
    gen = torch.Generator().manual_seed(7)
    assert torch.equal(cim_matmul(x, w, noseed, key=gen),
                       cim_matmul(x, w, dataclasses.replace(noseed,
                                                            noise_seed=7)))


@pytest.mark.parametrize("level", ["noisy", "full"])
def test_eager_distribution_matches_kernel(level):
    """The kernel's error distribution (vs the IDEAL output) against the
    eager backends': the same σ within (0.85, 1.18), the same mean within
    6σ/√n (tests/test_engine.py's bounds)."""
    x = torch.from_numpy(np.maximum(_act(23, (48, 432)), 0))
    w = torch.from_numpy(_act(24, (432, 32), 0.1))
    ideal = cim_matmul(x, w, CIMConfig(enabled=True, backend="einsum"))
    _, cfg = _cfgs(level, seed=3)
    e_k = (cim_matmul(x, w, cfg) - ideal).numpy().ravel()
    for backend in ("einsum", "scan"):
        e_e = (cim_matmul(x, w, dataclasses.replace(cfg, backend=backend))
               - ideal).numpy().ravel()
        ratio = float(np.std(e_k)) / max(float(np.std(e_e)), 1e-12)
        assert 0.85 < ratio < 1.18, (backend, np.std(e_k), np.std(e_e))
        scale = float(np.std(e_e)) / np.sqrt(e_e.size)
        assert abs(float(np.mean(e_k) - np.mean(e_e))) < 6 * scale


@pytest.mark.parametrize("inl_seed", [0, 3])
def test_cim_matmul_noisy_bit_exact(inl_seed):
    x = _act(3, (2, 3, 290))
    w = _act(4, (290, 33), 0.1)
    rcfg, tcfg = _cfgs(seed=5)
    yr = np.asarray(ref_cim.cim_matmul(jnp.asarray(x), jnp.asarray(w), rcfg,
                                       inl_seed=inl_seed))
    yt = cim_matmul(torch.from_numpy(x), torch.from_numpy(w), tcfg,
                    inl_seed=inl_seed).numpy()
    assert np.array_equal(yr, yt)


@pytest.mark.parametrize("packed", [True, False])
def test_cim_matmul_prequant_noisy_bit_exact(packed):
    x = _act(1, (4, 1, 300))
    w = _act(2, (300, 48), 0.1)
    rcfg, tcfg = _cfgs(seed=4)
    rc, rs = ref_cim.quantize_weight_offline(jnp.asarray(w), rcfg)
    tc, ts = quantize_weight_offline(torch.from_numpy(w), tcfg)
    if packed:
        rc, tc = ref_ops.pack_codes(rc), ops.pack_codes(tc)
    yr = np.asarray(ref_cim.cim_matmul_prequant(jnp.asarray(x), rc, rs,
                                                rcfg))
    yt = cim_matmul_prequant(torch.from_numpy(x), tc, ts, tcfg).numpy()
    assert np.array_equal(yr, yt)
    plain = cim_matmul_prequant(torch.from_numpy(x), tc, ts,
                                dataclasses.replace(tcfg, backend="plain"))
    assert np.array_equal(plain.numpy(), yt)


def test_noisy_wrappers_count_only_kernel_launches():
    x = torch.from_numpy(_codes(1, (2, 300)))
    w = torch.from_numpy(_codes(2, (300, 5)))
    _, tmac = _macros("noisy")
    before = (cim_mvm.cim_mvm_grouped_noisy.launches,
              cim_mvm.cim_mvm_grouped_noisy_packed.launches)
    ops.cim_mvm_noisy(x, w, tmac, noise_seed=_seed(0))
    ops.cim_mvm_noisy_packed(x, ops.pack_codes(w), tmac, noise_seed=_seed(0))
    assert (cim_mvm.cim_mvm_grouped_noisy.launches,
            cim_mvm.cim_mvm_grouped_noisy_packed.launches) == before


def test_serve_launcher_bp_noisy_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--smoke", "--paged", "--requests", "2", "--max-new", "3",
                "--cim", "bp-noisy", "--attn", "kernel", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("req") >= 2 and "cim=bp-noisy" in out


if __name__ == "__main__":
    # The measurements behind this file's tolerances and crafted cases, on
    # the CPU (a few minutes):
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_noisy.py
    f32 = np.float32
    _, inv = cim_mvm.adc_constants(362, 1.0, 32400.0)
    parts = np.arange(0, 32190, dtype=np.float32)
    xs = (parts * f32(inv)).astype(np.float32)
    rows = torch.arange(8).view(8, 1)
    cols = torch.arange(128).view(1, 128)
    found = []
    for seed in range(40):
        base = cim_mvm._counter_base(cim_mvm.salt_seed(seed, 0).to(
            torch.int64) & 0xFFFFFFFF, rows, cols, 0)
        nz = cim_mvm._normal12(base).numpy()
        sep = np.round((xs[None, None] + (f32(0.277) * nz)[..., None])
                       .astype(np.float32))
        fused = np.round((xs[None, None].astype(np.float64)
                          + np.float64(f32(0.277)) * nz[..., None])
                         .astype(np.float32))
        for m, n, p in np.argwhere(sep != fused)[:2]:
            found.append((seed, int(m), int(n), int(parts[p])))
    rmac, tmac = _macros("noisy")
    follow = 0
    for seed, m, n, part in found:
        x, w = _crafted_tie(seed, m, n, part)
        yr = _ref_b5(x, w, rmac, seed, 0)
        follow += round(float(yr[m, n] / LSB)) != _separate_add_code(
            seed, m, n, part)
    print(f"NOISY: the reference follows the fused multiply-add on {follow} "
          f"of {len(found)} crafted rounding ties")
    rmac, tmac = _macros("full")
    diff = total = 0
    for seed in (0, 7):
        x, w = _codes(seed, (512, 5760)), _codes(seed + 1, (5760, 1024))
        yr = _ref_b5(x, w, rmac, seed, 3)
        yt = ops.cim_mvm_noisy(torch.from_numpy(x), torch.from_numpy(w), tmac,
                               noise_seed=_seed(seed), inl_seed=3).numpy()
        diff += int((yr != yt).sum())
        total += yr.size
    print(f"FULL: {diff} of {total} outputs differ from the reference")

    def as_written(seed, *, levels, sigma, inl_amp, inl_seed, apply_inl):
        """The FULL transfer with the code fraction divided as the
        reference writes it, (part * inv_lsb) / L."""
        from repro_torch.core.adc import fma_f32

        def transfer(parts, inv_lsb):
            g, m, n = parts.shape
            frac = torch.clamp(parts * inv_lsb / torch.tensor(
                float(levels)), 0.0, 1.0)
            x = fma_f32(parts, inv_lsb, inl_curve(frac, inl_amp, inl_seed))
            salted = (seed.to(torch.int64) & 0xFFFFFFFF) \
                ^ cim_mvm.salt_term(inl_seed)
            base = cim_mvm._counter_base(
                salted, torch.arange(m).view(1, m, 1),
                torch.arange(n).view(1, 1, n), torch.arange(g).view(g, 1, 1))
            return fma_f32(cim_mvm._f32(sigma), cim_mvm._normal12(base), x)
        return transfer

    x, w = _codes(128, (128, 1440)), _codes(512, (1440, 512))
    yr = _ref_b5(x, w, rmac, 7, 3)
    folded = cim_mvm._noisy_transfer
    cim_mvm._noisy_transfer = as_written
    try:
        yt = ops.cim_mvm_noisy(torch.from_numpy(x), torch.from_numpy(w), tmac,
                               noise_seed=_seed(7), inl_seed=3).numpy()
    finally:
        cim_mvm._noisy_transfer = folded
    print(f"FULL, code fraction divided as written: {int((yr != yt).sum())} "
          f"of {yr.size} outputs differ at 128 x 1440 x 512")
    cf = np.linspace(0.0, 1.0, 200001).astype(np.float32)
    worst = max(float(np.max(np.abs(
        inl_curve(torch.from_numpy(cf), 1.1, s).numpy()
        - np.asarray(jax.jit(lambda c, s=s: ref_inl_curve(c, 1.1, s))(
            jnp.asarray(cf)))))) for s in (0, 3, 11))
    print(f"inl_curve: max |port - jitted reference| = {worst:.3g} LSB")
