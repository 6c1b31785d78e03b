"""Kernels B1/B2 and the CIM matmul path: the port against the reference.

The plain versions of B1 (packed) and B2 (dense) must be BIT-EXACT
against the Pallas kernels in interpret mode, and so must the whole
`cim_matmul` / `cim_matmul_prequant` path on the same f32 inputs: every
stage is integer code arithmetic plus the same f32 roundings in the same
order. Inputs come from numpy seeds. The card-side tests are in
test_torch_gpu.py.
"""
import importlib

import numpy as np
import pytest
import torch

from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.macro import MacroConfig as RefMacro  # noqa: E402
from repro.core.schemes import bp_mvm as ref_bp_mvm  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.cim_matmul import (CIMConfig, cim_matmul,  # noqa: E402
                                         cim_matmul_prequant,
                                         quantize_weight_offline)
from repro_torch.core.macro import MacroConfig, Scheme, SimLevel  # noqa: E402
from repro_torch.core.quant import WeightQuantConfig  # noqa: E402
from repro_torch.core.schemes import bp_mvm  # noqa: E402
from repro_torch.kernels import cim_mvm, ops  # noqa: E402

ref_cim = importlib.import_module("repro.core.cim_matmul")

# ragged shapes: odd K, K not a multiple of 144, M and N not multiples of
# 128, plus a main-path width
SHAPES = [(1, 1, 1), (3, 301, 70), (5, 288, 129), (9, 1001, 33),
          (130, 145, 257), (4, 2048, 64)]


def _codes(seed, shape):
    return np.random.RandomState(seed).randint(0, 16, shape) \
        .astype(np.float32)


@pytest.mark.parametrize("k,n,lead", [(7, 5, ()), (8, 3, ()), (301, 17, ()),
                                      (9, 4, (3,))])
def test_pack_unpack_colsums_bit_exact(k, n, lead):
    w = _codes(k * n, lead + (k, n))
    pr = np.asarray(ref_ops.pack_codes(jnp.asarray(w)))
    pt = ops.pack_codes(torch.from_numpy(w)).numpy()
    assert pt.dtype == np.uint8 and np.array_equal(pr, pt)
    for kk in (None, k):
        ur = np.asarray(ref_ops.unpack_codes(jnp.asarray(pr), kk))
        ut = ops.unpack_codes(torch.from_numpy(pt), kk).numpy()
        assert np.array_equal(ur, ut)
    assert np.array_equal(np.asarray(ref_ops.packed_col_sums(jnp.asarray(pr))),
                          ops.packed_col_sums(torch.from_numpy(pt)).numpy())


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_b2_bit_exact_vs_pallas(m, k, n):
    x, w = _codes(m, (m, k)), _codes(n + 1, (k, n))
    yr = np.asarray(ref_ops.cim_mvm_pallas(jnp.asarray(x), jnp.asarray(w),
                                           RefMacro(), interpret=True))
    yt = ops.cim_mvm_dense(torch.from_numpy(x), torch.from_numpy(w),
                           MacroConfig()).numpy()
    assert np.array_equal(yr, yt)


# macro depths other than the default 144 (the reference's own tests run
# n_rows=9, tests/test_sqnr.py): (n_rows, M, K, N) at the decode and the
# prefill row counts
DEPTH_SHAPES = [(9, 4, 100, 40), (9, 64, 90, 20), (145, 4, 300, 33),
                (145, 64, 200, 18), (1024, 4, 2100, 24),
                (1024, 64, 1500, 17)]


@pytest.mark.parametrize("n_rows,m,k,n", DEPTH_SHAPES)
def test_plain_b2_bit_exact_vs_pallas_other_depths(n_rows, m, k, n):
    x, w = _codes(m + k, (m, k)), _codes(n + k, (k, n))
    yr = np.asarray(ref_ops.cim_mvm_pallas(
        jnp.asarray(x), jnp.asarray(w), RefMacro(n_rows=n_rows),
        interpret=True))
    yt = ops.cim_mvm_dense(torch.from_numpy(x), torch.from_numpy(w),
                           MacroConfig(n_rows=n_rows)).numpy()
    assert np.array_equal(yr, yt)
    if n_rows % 2 == 0:
        wp = ops.pack_codes(torch.from_numpy(w))
        assert np.array_equal(ops.cim_mvm_packed(
            torch.from_numpy(x), wp, MacroConfig(n_rows=n_rows)).numpy(), yr)


@pytest.mark.parametrize("n_rows,packed,error", [
    (1, False, None), (9, False, None), (145, False, None),
    (7400, False, None), (0, False, "at least one row"),
    (2, True, None), (1024, True, None),
    (cim_mvm.PACKED_MAX_ROWS, True, None), (9, True, "even macro depth"),
    (145, True, "even macro depth"),
    (cim_mvm.PACKED_MAX_ROWS + 2, True, "at most")])
def test_kernel_depth_check(n_rows, packed, error):
    """The dense kernels take every depth >= 1, as the reference's do; the
    packed ones only even depths (the reference's packed kernels assert
    it), up to what their shared memory holds."""
    if error is None:
        cim_mvm.check_depth(n_rows, packed)
        return
    with pytest.raises(ValueError, match=error):
        cim_mvm.check_depth(n_rows, packed)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_b1_bit_exact_vs_pallas(m, k, n):
    x, w = _codes(m + 7, (m, k)), _codes(n + 9, (k, n))
    wp = np.array(ref_ops.pack_codes(jnp.asarray(w)))
    yr = np.asarray(ref_ops.cim_mvm_pallas_packed(
        jnp.asarray(x), jnp.asarray(wp), RefMacro(), interpret=True))
    yt = ops.cim_mvm_packed(torch.from_numpy(x), torch.from_numpy(wp),
                            MacroConfig()).numpy()
    assert np.array_equal(yr, yt)


@pytest.mark.parametrize("gain,vdd", [(2.0, 0.9), (1.0, 0.7)])
def test_plain_b1_bit_exact_other_transfer(gain, vdd):
    """VTC gain > 1 and a de-rated ADC (fewer levels) change lsb and L."""
    from repro.core.macro import OperatingPoint as RefOp
    from repro_torch.core.macro import OperatingPoint
    x, w = _codes(1, (6, 500)), _codes(2, (500, 40))
    wp = np.array(ref_ops.pack_codes(jnp.asarray(w)))
    yr = np.asarray(ref_ops.cim_mvm_pallas_packed(
        jnp.asarray(x), jnp.asarray(wp),
        RefMacro(gain=gain, op=RefOp(vdd=vdd)), interpret=True))
    yt = ops.cim_mvm_packed(
        torch.from_numpy(x), torch.from_numpy(wp),
        MacroConfig(gain=gain, op=OperatingPoint(vdd=vdd))).numpy()
    assert np.array_equal(yr, yt)


def _act(seed, shape, signed=True):
    rng = np.random.RandomState(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    return a if signed else np.abs(a)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("shape", [(2, 3, 300), (4, 1, 129)])
def test_cim_matmul_prequant_bit_exact(shape, packed, per_channel):
    x = _act(1, shape)
    w = _act(2, (shape[-1], 48)) * 0.1
    rcfg = ref_cim.CIMConfig(enabled=True, weight=ref_cim.WeightQuantConfig(
        per_channel=per_channel))
    tcfg = CIMConfig(enabled=True,
                     weight=WeightQuantConfig(per_channel=per_channel))
    rc, rs = ref_cim.quantize_weight_offline(jnp.asarray(w), rcfg)
    tc, ts = quantize_weight_offline(torch.from_numpy(w), tcfg)
    assert np.array_equal(np.asarray(rc), tc.numpy())
    assert np.array_equal(np.asarray(rs), ts.numpy())
    if packed:
        rc, tc = ref_ops.pack_codes(rc), ops.pack_codes(tc)
    yr = np.asarray(ref_cim.cim_matmul_prequant(jnp.asarray(x), rc, rs, rcfg))
    yt = cim_matmul_prequant(torch.from_numpy(x), tc, ts, tcfg).numpy()
    assert np.array_equal(yr, yt)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("shape", [(3, 200), (2, 2, 290)])
def test_cim_matmul_bit_exact(shape, signed):
    x = _act(3, shape, signed)
    w = _act(4, (shape[-1], 33))
    yr = np.asarray(ref_cim.cim_matmul(jnp.asarray(x), jnp.asarray(w),
                                       ref_cim.CIMConfig(enabled=True)))
    yt = cim_matmul(torch.from_numpy(x), torch.from_numpy(w),
                    CIMConfig(enabled=True)).numpy()
    assert np.array_equal(yr, yt)


def test_cim_matmul_disabled_is_float_matmul():
    x, w = _act(5, (3, 7)), _act(6, (7, 4))
    y = cim_matmul(torch.from_numpy(x), torch.from_numpy(w), CIMConfig())
    np.testing.assert_allclose(y.numpy(), x @ w, rtol=1e-6, atol=1e-6)


def test_bp_mvm_vs_reference():
    """schemes.bp_mvm divides by the LSB and sums groups at the end, in
    both packages; it agrees with the reference to float rounding of the
    group sum (f32 ulps of the ~1e5 output: atol 0.1, the reference's own
    bound for this oracle)."""
    x, w = _codes(7, (5, 700)), _codes(8, (700, 20))
    yr = np.asarray(ref_bp_mvm(jnp.asarray(x), jnp.asarray(w), RefMacro()))
    yt = bp_mvm(torch.from_numpy(x), torch.from_numpy(w),
                MacroConfig()).numpy()
    np.testing.assert_allclose(yt, yr, rtol=1e-6, atol=1e-1)


def test_engine_registry_and_choice():
    assert set(engine.available_backends()) == {
        "cuda", "cuda_packed", "cuda_noisy", "cuda_noisy_packed", "einsum",
        "scan", "plain"}
    cfg = CIMConfig(enabled=True)
    x = torch.zeros(2, 8)
    w = torch.zeros(8, 3)
    assert engine.choose_backend(cfg, x, w) == "cuda"
    assert engine.choose_backend(
        cfg, x, engine.PackedCodes(ops.pack_codes(w), 8)) == "cuda_packed"
    with pytest.raises(ValueError, match="unknown CIM backend"):
        engine.get_backend("pallas")


@pytest.mark.parametrize("what,item", [("scheme", "A8"), ("scheme-bs", "A8"),
                                       ("scheme-noisy", "A8")])
def test_engine_unported_raises(what, item):
    """The WBS/BS baselines (ROADMAP A8, pulled forward with A7) run on the
    einsum backend, as the reference routes them: auto resolves them to
    einsum at IDEAL and at NOISY with a noise_seed, the result equals the
    reference's at IDEAL and is seeded-reproducible at NOISY, and a kernel
    backend named explicitly still raises for them."""
    import dataclasses
    scheme = Scheme.BS if what == "scheme-bs" else Scheme.WBS
    cfg = CIMConfig(enabled=True).with_scheme(scheme)
    rcfg = ref_cim.CIMConfig(enabled=True).with_scheme(
        importlib.import_module("repro.core.macro").Scheme(scheme.value))
    if what == "scheme-noisy":
        cfg = dataclasses.replace(cfg, noise_seed=0, macro=dataclasses.replace(
            cfg.macro, sim_level=SimLevel.NOISY))
    x, w = torch.ones(2, 8), torch.ones(8, 3)
    assert engine.choose_backend(cfg, x, w) == "einsum"
    y = cim_matmul(x, w, cfg)
    assert y.shape == (2, 3) and bool(torch.isfinite(y).all())
    if what == "scheme-noisy":
        assert torch.equal(y, cim_matmul(x, w, cfg))
    else:
        assert np.array_equal(y.numpy(), np.asarray(ref_cim.cim_matmul(
            jnp.ones((2, 8)), jnp.ones((8, 3)), rcfg)))
    with pytest.raises(ValueError, match="does not implement scheme"):
        cim_matmul(x, w, dataclasses.replace(cfg, backend="cuda"))


@pytest.mark.parametrize("packed", [True, False])
def test_plain_backend_equals_auto_on_cpu(packed):
    import dataclasses
    x = torch.from_numpy(_act(9, (4, 300)))
    w = torch.from_numpy(_act(10, (300, 21)))
    cfg = CIMConfig(enabled=True)
    codes, scale = quantize_weight_offline(w, cfg)
    if packed:
        codes = ops.pack_codes(codes)
    y_auto = cim_matmul_prequant(x, codes, scale, cfg)
    y_plain = cim_matmul_prequant(x, codes, scale,
                                  dataclasses.replace(cfg, backend="plain"))
    assert torch.equal(y_auto, y_plain)


def test_wrappers_count_only_kernel_launches():
    x = torch.from_numpy(_codes(1, (2, 300)))
    w = torch.from_numpy(_codes(2, (300, 5)))
    before = (cim_mvm.cim_mvm_grouped.launches,
              cim_mvm.cim_mvm_grouped_packed.launches)
    ops.cim_mvm_dense(x, w, MacroConfig())
    ops.cim_mvm_packed(x, ops.pack_codes(w), MacroConfig())
    assert (cim_mvm.cim_mvm_grouped.launches,
            cim_mvm.cim_mvm_grouped_packed.launches) == before
