"""Mixed precision, the precision manifest, the baseline schemes, SQNR,
mapping and energy: the port against the reference.

Integer and code stages are held BIT-EXACT against the reference run
eagerly on the same numpy inputs: the WBS/BS/BP `cim_mvm_codes`
(`schemes.group_sum` adds the groups in the reference's order),
`exact_mvm_codes`, `extended_mvm_codes` and the plain kernel versions at
every ADC level of `ADC_BIT_CANDIDATES` against the Pallas kernels in
interpret mode. The energy model and the mapping are float64 arithmetic,
held to rtol 1e-12. The SQNR Monte-Carlo draws its codes from a
torch.Generator (jax.random's bits cannot be reproduced), so `_sqnr_batch`
is held on SHARED codes (rtol 1e-6) and `simulate_sqnr` in dB only within
the stated Monte-Carlo tolerance, plus the paper's Fig. 2 orderings.
The search runs with the reference fixture's cheap settings
(`bit_candidates=(7.0,)`, `try_per_channel=False`) on the float32 smoke
config, with the weights carried over by `params_from_numpy`.
"""
import dataclasses
import importlib
import json
import os
import warnings

import numpy as np
import pytest
import torch

from _torch_helpers import normalize, to_numpy_tree
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.analysis import precision_search as rps  # noqa: E402
from repro.configs.registry import SMOKES as REF_SMOKES  # noqa: E402
from repro.core import dac as ref_dac  # noqa: E402
from repro.core import mapping as ref_mapping  # noqa: E402
from repro.core import precision as ref_prec  # noqa: E402
from repro.core import quant as ref_quant  # noqa: E402
from repro.core import schemes as ref_schemes  # noqa: E402
from repro.core import sqnr as ref_sqnr  # noqa: E402
from repro.core.macro import MacroConfig as RefMacro  # noqa: E402
from repro.core.macro import Scheme as RefScheme  # noqa: E402
from repro.core.macro import SimLevel as RefLevel  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_kref  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro_torch.analysis import precision_search as tps  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
# the module, not the function the package re-exports under its name
tcim = importlib.import_module("repro_torch.core.cim_matmul")
from repro_torch.core import dac, mapping, precision  # noqa: E402
from repro_torch.core import quant, schemes, sqnr  # noqa: E402
from repro_torch.core.macro import MacroConfig, Scheme, SimLevel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.models import registry  # noqa: E402

ref_cim = importlib.import_module("repro.core.cim_matmul")
REPO = os.path.join(os.path.dirname(__file__), "..")
MAX_LEN = 64
LADDER = tuple(sorted({precision.adc_levels_for_bits(b)
                       for b in precision.ADC_BIT_CANDIDATES}))
SEARCH_KW = dict(seed=0, bit_candidates=(7.0,), try_per_channel=False)
# simulate_sqnr's codes come from another generator than the reference's;
# at the Fig. 2 settings (K = 144, 8192 samples, 2 weight columns) the
# port's seed-0 SQNR lay 2.29-2.53 dB below the reference's in all nine
# configs below, while the port's own seeds 0-11 spread 11.9 dB at BP /
# 362 levels: the absolute dB agree in distribution only
SQNR_DB_TOL = 3.0
# the screen's native-minus-candidate SQNR drop, port vs reference, at the
# (K, levels) the search visits on the smoke config: measured gap 0.18 dB
SQNR_DROP_TOL = 0.5
# the search's KL values, port vs reference: measured 4.8e-7 (the
# calibrated grids differ in the last bits of lo/hi)
KL_ATOL = 1e-5


def _codes(seed, shape, hi=16):
    return np.random.RandomState(seed).randint(0, hi, shape) \
        .astype(np.float32)


def _macros(**kw):
    ref = {k: (RefScheme(v) if k == "scheme" else RefLevel(v)
               if k == "sim_level" else v) for k, v in kw.items()}
    port = {k: (Scheme(v) if k == "scheme" else SimLevel(v)
                if k == "sim_level" else v) for k, v in kw.items()}
    return RefMacro(**ref), MacroConfig(**port)


# ---------------------------------------------------------------------------
# schemes: BP / WBS / BS and the exact reference, bit-exact at IDEAL
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("levels", [362, 45, 256])
@pytest.mark.parametrize("k", [144, 300, 2048, 8192])
@pytest.mark.parametrize("scheme", ["bp", "wbs", "bs"])
def test_cim_mvm_codes_bit_exact(scheme, k, levels):
    rmac, tmac = _macros(scheme=scheme, adc_levels=levels)
    x, w = _codes(k, (5, k)), _codes(k + 1, (k, 7))
    yr = np.asarray(ref_schemes.cim_mvm_codes(jnp.asarray(x),
                                              jnp.asarray(w), rmac))
    yt = schemes.cim_mvm_codes(torch.from_numpy(x), torch.from_numpy(w),
                               tmac).numpy()
    assert np.array_equal(yr, yt)
    exact_r = np.asarray(ref_schemes.exact_mvm_codes(jnp.asarray(x),
                                                     jnp.asarray(w)))
    exact_t = schemes.exact_mvm_codes(torch.from_numpy(x),
                                      torch.from_numpy(w)).numpy()
    assert np.array_equal(exact_r, exact_t)


@pytest.mark.parametrize("g", [1, 5, 16, 32, 33, 57, 65, 129, 643])
def test_group_sum_follows_the_reference_order(g):
    """jnp.sum over the group axis in f32, bit for bit, at group counts on
    both sides of XLA's 32-wide reduction windows."""
    q = (_codes(g, (3, g, 6), hi=362) * np.float32(32400 / 361)) \
        .astype(np.float32)
    ref = np.asarray(jnp.sum(jnp.asarray(q), axis=-2))
    assert np.array_equal(schemes.group_sum(torch.from_numpy(q)).numpy(),
                          ref)


def test_bit_planes_bit_exact():
    q = _codes(3, (4, 37))
    for bits in (1, 4):
        ref = np.asarray(ref_quant.bit_planes(jnp.asarray(q), bits))
        got = quant.bit_planes(torch.from_numpy(q), bits).numpy()
        assert got.dtype == np.float32 and np.array_equal(ref, got)


def test_wbs_bs_run_on_the_einsum_backend():
    """The engine routes WBS/BS to einsum, as the reference's
    choose_backend does, and cim_matmul equals the reference's; the plain
    backend runs them on einsum too."""
    from repro_torch.core import engine
    x = np.random.RandomState(0).randn(3, 300).astype(np.float32)
    w = np.random.RandomState(1).randn(300, 9).astype(np.float32)
    for sch in ("wbs", "bs"):
        rcfg = ref_cim.CIMConfig(enabled=True).with_scheme(RefScheme(sch))
        tcfg = tcim.CIMConfig(enabled=True).with_scheme(Scheme(sch))
        assert engine.choose_backend(tcfg, torch.from_numpy(x),
                                     torch.from_numpy(w)) == "einsum"
        yr = np.asarray(ref_cim.cim_matmul(jnp.asarray(x), jnp.asarray(w),
                                           rcfg))
        yt = tcim.cim_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             tcfg).numpy()
        assert np.array_equal(yr, yt)
        # the plain backend (the kernels' yardstick) runs them on einsum
        codes, scale = tcim.quantize_weight_offline(torch.from_numpy(w),
                                                    tcfg)
        packed = ops.pack_codes(codes)
        y_auto = tcim.cim_matmul_prequant(torch.from_numpy(x), packed,
                                          scale, tcfg)
        assert torch.equal(y_auto, tcim.cim_matmul_prequant(
            torch.from_numpy(x), packed, scale,
            dataclasses.replace(tcfg, backend="plain")))


# ---------------------------------------------------------------------------
# precision extension (8-bit nibble passes)
# ---------------------------------------------------------------------------
def test_split_nibbles_and_ladder():
    codes = np.arange(256.0, dtype=np.float32)
    hr, lr = ref_prec.split_nibbles(jnp.asarray(codes))
    ht, lt = precision.split_nibbles(torch.from_numpy(codes))
    assert np.array_equal(np.asarray(hr), ht.numpy())
    assert np.array_equal(np.asarray(lr), lt.numpy())
    assert precision.ADC_BIT_CANDIDATES == ref_prec.ADC_BIT_CANDIDATES
    assert LADDER == (32, 45, 64, 91, 128, 181, 256, 362)
    for b in precision.ADC_BIT_CANDIDATES + (3.0, 9.3):
        assert precision.adc_levels_for_bits(b) \
            == ref_prec.adc_levels_for_bits(b)
    for lv in LADDER:
        assert precision.adc_bits_for_levels(lv) \
            == ref_prec.adc_bits_for_levels(lv)


@pytest.mark.parametrize("levels", [362, 32401])
def test_extended_mvm_codes_bit_exact(levels):
    x, w = _codes(5, (4, 288), hi=256), _codes(6, (288, 5), hi=256)
    rmac, tmac = _macros(adc_levels=levels)
    yr = np.asarray(ref_prec.extended_mvm_codes(jnp.asarray(x),
                                                jnp.asarray(w), rmac))
    yt = precision.extended_mvm_codes(torch.from_numpy(x),
                                      torch.from_numpy(w), tmac).numpy()
    assert np.array_equal(yr, yt)
    if levels == 32401:    # one LSB per nibble pass: lossless
        assert np.array_equal(yt, x @ w)


def test_extended_matmul_bit_exact_and_beats_4bit():
    rng = np.random.RandomState(2)
    x = np.maximum(rng.randn(16, 288), 0).astype(np.float32)
    w = (rng.randn(288, 8) * 0.1).astype(np.float32)
    rmac, tmac = _macros(gain=3.0)
    yr = np.asarray(ref_prec.extended_matmul(jnp.asarray(x), jnp.asarray(w),
                                             rmac))
    y8 = precision.extended_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   tmac)
    assert np.array_equal(yr, y8.numpy())
    y4 = tcim.cim_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         tcim.CIMConfig(enabled=True, macro=tmac,
                                        backend="einsum"))
    ref = torch.from_numpy(x @ w)
    assert torch.linalg.norm(y8 - ref) < torch.linalg.norm(y4 - ref)


# ---------------------------------------------------------------------------
# the kernels' plain versions at every rung of the ADC ladder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("levels", LADDER[:-1])
def test_plain_kernels_bit_exact_vs_pallas_on_the_ladder(levels):
    """B2/B1 (IDEAL) and B5/B6 (NOISY, seed 3) plain versions against the
    Pallas kernels in interpret mode at ADC levels other than 362: lsb,
    inv_lsb and code_max change with L, computed in float64 and rounded
    to f32 as the reference's kernels receive them. The oracle
    kernels/ref.py divides by the LSB; it is the reference's oracle bit
    for bit and within one ADC step of the kernels."""
    x, w = _codes(levels, (4, 300)), _codes(levels + 1, (300, 33))
    wp = ops.pack_codes(torch.from_numpy(w))
    rmac, tmac = _macros(adc_levels=levels)
    xj, wj, wpj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(wp.numpy())
    b2 = ops.cim_mvm_dense(torch.from_numpy(x), torch.from_numpy(w), tmac)
    assert np.array_equal(np.asarray(ref_ops.cim_mvm_pallas(
        xj, wj, rmac, interpret=True)), b2.numpy())
    assert np.array_equal(np.asarray(ref_ops.cim_mvm_pallas_packed(
        xj, wpj, rmac, interpret=True)),
        ops.cim_mvm_packed(torch.from_numpy(x), wp, tmac).numpy())
    rn, tn = _macros(adc_levels=levels, sim_level="noisy")
    seed = torch.tensor([3], dtype=torch.int32)
    y5 = ops.cim_mvm_noisy(torch.from_numpy(x), torch.from_numpy(w), tn,
                           noise_seed=seed).numpy()
    assert np.array_equal(np.asarray(ref_ops.cim_mvm_pallas_noisy(
        xj, wj, rn, noise_seed=3, interpret=True)), y5)
    assert np.array_equal(np.asarray(ref_ops.cim_mvm_pallas_noisy_packed(
        xj, wpj, rn, noise_seed=3, interpret=True)),
        ops.cim_mvm_noisy_packed(torch.from_numpy(x), wp, tn,
                                 noise_seed=seed).numpy())
    kw = dict(n_rows=144, levels=levels, gain=1.0, full_scale=32400.0)
    xp = np.pad(x, ((0, 0), (0, 132)))
    wpad = np.pad(w, ((0, 132), (0, 0)))
    oracle = kref.cim_mvm_ref(torch.from_numpy(xp), torch.from_numpy(wpad),
                              **kw).numpy()
    assert np.array_equal(oracle, np.asarray(ref_kref.cim_mvm_ref(
        jnp.asarray(xp), jnp.asarray(wpad), **kw)))
    lsb = 32400.0 / (levels - 1)
    assert np.abs(oracle - b2.numpy()).max() <= 3 * lsb * (1 + 1e-6)


# ---------------------------------------------------------------------------
# SQNR (Eq. 3)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme,levels", [("bp", 362), ("bp", 128),
                                           ("wbs", 256), ("bs", 32)])
@pytest.mark.parametrize("signed", [True, False])
def test_sqnr_batch_on_shared_codes(scheme, levels, signed):
    """The same numpy codes through the port's _sqnr_batch and the
    reference's flow (cim_mvm_codes, exact_mvm_codes, signed_correction):
    Σ y² and Σ (y − ŷ)² agree to rtol 1e-6 (f32 sums in another order)."""
    k = 288
    x = _codes(1, (512, k))
    if signed:
        w = np.clip(np.round(np.random.RandomState(2).randn(k, 1) * 4.7),
                    -8, 7).astype(np.float32) + 8
    else:
        w = _codes(2, (k, 1))
    offset = 8 if signed else 0
    rmac, tmac = _macros(scheme=scheme, adc_levels=levels)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    y_hat = ref_schemes.cim_mvm_codes(xj, wj, rmac)
    y_ref = ref_schemes.exact_mvm_codes(xj, wj)
    if offset:
        zp = jnp.zeros(())
        y_hat = ref_schemes.signed_correction(y_hat, xj, wj, w_offset=offset,
                                              x_zero_point=zp)
        y_ref = ref_schemes.signed_correction(y_ref, xj, wj, w_offset=offset,
                                              x_zero_point=zp)
    sig_r = float(jnp.sum(y_ref ** 2))
    err_r = float(jnp.sum((y_ref - y_hat) ** 2))
    sig_t, err_t = sqnr._sqnr_batch(tmac, torch.from_numpy(x),
                                    torch.from_numpy(w), offset)
    assert float(sig_t) == pytest.approx(sig_r, rel=1e-6)
    assert float(err_t) == pytest.approx(err_r, rel=1e-6)


def test_truncated_gaussian_codes_in_range_and_seeded():
    g = torch.Generator().manual_seed(0)
    s = sqnr.sample_truncated_gaussian_codes(g, (4096,), 4, signed=True)
    u = sqnr.sample_truncated_gaussian_codes(g, (4096,), 4, signed=False)
    assert s.min() >= -8 and s.max() <= 7 and u.min() >= 0 and u.max() <= 15
    assert abs(float(u.mean()) - 7.5) < 0.3
    again = sqnr.sample_truncated_gaussian_codes(
        torch.Generator().manual_seed(0), (4096,), 4, signed=True)
    assert torch.equal(s, again)


N_FAST = 1 << 13


def _sqnr_pair(scheme, **kw):
    rmac, tmac = _macros(scheme=scheme, **kw)
    r = ref_sqnr.simulate_sqnr(rmac, k=144, n_samples=N_FAST)
    t = sqnr.simulate_sqnr(tmac, k=144, n_samples=N_FAST, device="cpu")
    assert abs(t.sqnr_db - r.sqnr_db) < SQNR_DB_TOL
    assert t.energy_per_mvm_j == pytest.approx(r.energy_per_mvm_j,
                                               rel=1e-12)
    assert t.tops_per_w == pytest.approx(r.tops_per_w, rel=1e-12)
    return t


def test_fig2b_bp_beats_wbs_and_bs_at_iso_energy():
    bp = _sqnr_pair("bp", adc_levels=1024)
    wbs = _sqnr_pair("wbs", adc_levels=256)
    bs = _sqnr_pair("bs", adc_levels=32)
    assert abs(bp.energy_per_mvm_j - wbs.energy_per_mvm_j) \
        / bp.energy_per_mvm_j < 0.01
    assert abs((bp.sqnr_db - wbs.sqnr_db) - 7.8) < 1.5
    assert abs((bp.sqnr_db - bs.sqnr_db) - 21.6) < 2.0


def test_fig2a_ordering_and_adc_bit():
    bp = _sqnr_pair("bp", adc_levels=64, n_rows=9)
    wbs = _sqnr_pair("wbs", adc_levels=64, n_rows=36)
    bs = _sqnr_pair("bs", adc_levels=64, n_rows=144)
    assert bp.sqnr_db > wbs.sqnr_db > bs.sqnr_db
    assert abs((bp.sqnr_db - wbs.sqnr_db) - 1.8) < 1.0
    assert abs((bp.sqnr_db - bs.sqnr_db) - 3.5) < 1.5
    lo = _sqnr_pair("bp", adc_levels=181)
    hi = _sqnr_pair("bp", adc_levels=362)
    assert abs((hi.sqnr_db - lo.sqnr_db) - 6.0) < 1.0
    n72 = _sqnr_pair("bp", adc_levels=362, n_rows=72)
    assert abs((n72.sqnr_db - hi.sqnr_db) - 3.0) < 1.2


# ---------------------------------------------------------------------------
# mapping and energy (float64 arithmetic)
# ---------------------------------------------------------------------------
def test_mapping_equals_reference():
    for args in (("ffn", 300, 20), ("head", 2048, 92544)):
        assert dataclasses.asdict(mapping.map_layer(*args)) \
            == dataclasses.asdict(ref_mapping.map_layer(*args))
    assert mapping.gru_144_shapes() == ref_mapping.gru_144_shapes()
    for shapes, n in ((mapping.gru_144_shapes(), 64),
                      ([("big", 4096, 4096)], 4)):
        t = mapping.map_model(shapes, mapping.MacroBudget(n_macros=n))
        r = ref_mapping.map_model(shapes, ref_mapping.MacroBudget(n_macros=n))
        assert (t.fits, t.total_weights, t.reload_bits_per_pass()) \
            == (r.fits, r.total_weights, r.reload_bits_per_pass())
        assert t.resident_fraction == pytest.approx(r.resident_fraction,
                                                    rel=1e-12)
        assert t.bank_utilization() == pytest.approx(r.bank_utilization(),
                                                     rel=1e-12)


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.9])
def test_dac_energy_equals_reference(sparsity):
    rng = np.random.RandomState(4)
    q = rng.randint(0, 16, (64, 144)).astype(np.float32)
    q[rng.rand(*q.shape) < sparsity] = 0.0
    for vdd in (0.65, 0.9, 1.2):
        rmac = RefMacro(op=dataclasses.replace(RefMacro().op, vdd=vdd))
        tmac = MacroConfig(op=dataclasses.replace(MacroConfig().op, vdd=vdd))
        frac_r = np.asarray(ref_dac.dac_switched_cap_fraction(
            jnp.asarray(q), rmac))
        frac_t = dac.dac_switched_cap_fraction(torch.from_numpy(q), tmac)
        assert np.array_equal(frac_r, frac_t.numpy())
        assert torch.equal(dac.dac_codes(torch.from_numpy(q)),
                           torch.from_numpy(q))
        e_r = float(ref_dac.dac_energy_j(jnp.asarray(q), rmac))
        e_t = float(dac.dac_energy_j(torch.from_numpy(q), tmac))
        assert e_t == pytest.approx(e_r, rel=1e-6)   # f32 mean, then f64


# ---------------------------------------------------------------------------
# the search, on the smoke config
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    rcfg = REF_SMOKES["internlm2-1.8b"].replace(
        dtype="float32", cim=ref_cim.CIMConfig(enabled=True))
    tcfg = SMOKES["internlm2-1.8b"].replace(
        dtype="float32", cim=tcim.CIMConfig(enabled=True))
    rp = ref_registry.init_params(jax.random.PRNGKey(0), rcfg,
                                  max_seq=MAX_LEN)
    tp = registry.params_from_numpy(to_numpy_tree(rp), tcfg, device="cpu")
    cal = np.random.RandomState(7).randint(0, rcfg.vocab, size=(2, 16))
    return rcfg, rp, tcfg, tp, cal


@pytest.fixture(scope="module")
def manifests(setup):
    rcfg, rp, tcfg, tp, cal = setup
    return (rps.search(rp, cal, rcfg, **SEARCH_KW),
            tps.search(tp, cal, tcfg, **SEARCH_KW))


def test_search_matches_reference(manifests):
    ref, port = manifests
    assert port["schema"] == ref["schema"] == "pico-ram/precision_manifest/v1"
    for key in ("arch", "seed", "act_qmax", "base_adc_levels"):
        assert port[key] == ref[key]
    assert port["sites"].keys() == ref["sites"].keys()
    for name, r in ref["sites"].items():
        t = port["sites"][name]
        for key in ("adc_levels", "scheme", "per_channel", "k", "m", "calls",
                    "act_zero_point"):
            assert t[key] == r[key], (name, key)
        assert t["act_scale"] == pytest.approx(r["act_scale"], rel=1e-6)
    rm, tm = ref["metrics"], port["metrics"]
    for key in ("uniform_pj_per_token", "mixed_pj_per_token", "energy_win"):
        assert tm[key] == pytest.approx(rm[key], rel=1e-9)
    for key in ("kl_uniform", "kl_proxy"):
        assert abs(tm[key] - rm[key]) < KL_ATOL
    assert [{k: v for k, v in s.items() if k != "kl"} for s in tm["trace"]] \
        == [{k: v for k, v in s.items() if k != "kl"} for s in rm["trace"]]
    assert tm["mixed_pj_per_token"] <= tm["uniform_pj_per_token"]
    assert tm["kl_proxy"] <= tm["kl_uniform"] + tm["kl_budget"] + 1e-9


def test_search_deterministic(setup, manifests):
    rcfg, rp, tcfg, tp, cal = setup
    assert tps.search(tp, cal, tcfg, **SEARCH_KW) == manifests[1]


def test_sqnr_screen_gap_to_reference(setup):
    """The screen's drop from native resolution at the (K, levels) the
    search visits on the smoke config: within SQNR_DROP_TOL of the
    reference's, and on the same side of the 9.5 dB floor."""
    rcfg, rp, tcfg, tp, cal = setup
    for k in (128, 256):
        r = {lv: rps._sqnr_db(rcfg, k, adc_levels=lv, scheme="bp", seed=0)
             for lv in (362, 128)}
        t = {lv: tps._sqnr_db(tcfg, k, adc_levels=lv, scheme="bp", seed=0,
                              device="cpu") for lv in (362, 128)}
        drop_r, drop_t = r[362] - r[128], t[362] - t[128]
        assert abs(drop_t - drop_r) < SQNR_DROP_TOL
        assert (drop_t < 9.5) == (drop_r < 9.5)


def test_energy_accounting_equals_reference(setup):
    rcfg, rp, tcfg, tp, cal = setup
    from repro.analysis.calibrate import calibrate_act_tree
    tree = calibrate_act_tree(rp, cal, rcfg)
    n_tok = cal.size
    over_r = {"w_up": ref_cim.SitePrecision(adc_levels=128, scheme="bp"),
              "wq": ref_cim.SitePrecision(adc_levels=45, scheme="wbs")}
    over_t = {"w_up": tcim.SitePrecision(adc_levels=128, scheme="bp"),
              "wq": tcim.SitePrecision(adc_levels=45, scheme="wbs")}
    for r_ov, t_ov in (({}, {}), (over_r, over_t)):
        assert tps.energy_per_token_j(tree, tcfg, t_ov, n_tok) \
            == pytest.approx(rps.energy_per_token_j(tree, rcfg, r_ov, n_tok),
                             rel=1e-12)
    for name, e in tree["sites"].items():
        for lv, sch in ((None, None), (91, "bs")):
            assert tps.site_energy_per_token_j(
                e, tcfg, adc_levels=lv, scheme=sch, n_tokens=n_tok) \
                == pytest.approx(rps.site_energy_per_token_j(
                    e, rcfg, adc_levels=lv, scheme=sch, n_tokens=n_tok),
                    rel=1e-12)


def test_site_overrides_change_the_matmul(setup):
    rcfg, rp, tcfg, tp, cal = setup
    from repro_torch.analysis.calibrate import calibrate_act_tree
    tree = calibrate_act_tree(tp, cal, tcfg)
    probe = np.random.RandomState(3).randint(0, tcfg.vocab, size=(1, 8))
    mod = registry.get_module(tcfg)
    base = tps._logits(tp, probe, tps._probe_cfg(tcfg, {}, tree), mod)
    coarse = tps._logits(tp, probe, tps._probe_cfg(
        tcfg, {"w_up": tcim.SitePrecision(adc_levels=32, scheme="bp")},
        tree), mod)
    assert not torch.allclose(base, coarse)


# ---------------------------------------------------------------------------
# SitePrecision, site resolution and the manifest
# ---------------------------------------------------------------------------
OVERRIDES = [dict(adc_levels=128), dict(scheme="wbs"),
             dict(act_scale=0.5, act_zero_point=3.0),
             dict(act_zero_point=2.0), dict(per_channel=True),
             dict(act_scale=0.25, adc_levels=45, scheme="bs",
                  per_channel=False)]


@pytest.mark.parametrize("ov", OVERRIDES)
def test_site_precision_apply_equals_reference(ov):
    r = ref_cim.CIMConfig(enabled=True, site_overrides=(
        ("wq", ref_cim.SitePrecision(**ov)),))
    t = tcim.CIMConfig(enabled=True, site_overrides=(
        ("wq", tcim.SitePrecision(**ov)),))
    for site in ("wq", "wk", None):
        assert normalize(t.for_site(site)) == normalize(r.for_site(site))
    for site in ("wq", "wk"):
        with quant.act_site(site):
            got = tcim.resolve_site_cfg(t)
            assert got is tcim.resolve_site_cfg(t)   # cached per (cfg, site)
            assert normalize(got) == normalize(r.for_site(site))


def test_load_manifest_committed_and_overrides_equal_reference():
    path = os.path.join(REPO, "precision_manifest.json")
    r = rps.load_manifest(path, arch="internlm2-1.8b")
    t = tps.load_manifest(path, arch="internlm2-1.8b")
    assert t == r and t is not None
    assert normalize(tps.manifest_overrides(t)) \
        == normalize(rps.manifest_overrides(r))
    base_t, base_r = tcim.CIMConfig(enabled=True), \
        ref_cim.CIMConfig(enabled=True)
    assert normalize(tps.apply_manifest(base_t, t)) \
        == normalize(rps.apply_manifest(base_r, r))
    assert tps.pareto_points(t) == rps.pareto_points(r)
    levels = {n: s["adc_levels"] for n, s in t["sites"].items()}
    assert levels == {"w_down": 128, "w_gate": 128, "w_up": 128, "wk": 128,
                      "wo": 128, "wq": 128, "wv": 181}


def test_manifest_round_trip(tmp_path, manifests):
    path = str(tmp_path / "man.json")
    tps.save_manifest(path, manifests[1])
    assert tps.load_manifest(path, arch=manifests[1]["arch"]) \
        == manifests[1]
    with open(path) as f:
        assert json.load(f) == manifests[1]


@pytest.mark.parametrize("corrupt", ["missing", "garbage", "schema", "arch"])
def test_manifest_degrades_to_uniform_defaults(tmp_path, manifests,
                                               corrupt):
    manifest = manifests[1]
    path = str(tmp_path / "man.json")
    if corrupt == "garbage":
        with open(path, "w") as f:
            f.write("{this is not json")
    elif corrupt == "schema":
        with open(path, "w") as f:
            json.dump(dict(manifest,
                           schema="pico-ram/precision_manifest/v999"), f)
    elif corrupt == "arch":
        tps.save_manifest(path, manifest)
    arch = "some-other-arch" if corrupt == "arch" else manifest["arch"]
    for mod in (tps, rps):
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            loaded = mod.load_manifest(path, arch=arch)
        assert loaded is None
        assert sum("precision manifest" in str(w.message) for w in ws) == 1
    cim = tcim.CIMConfig(enabled=True)
    assert tps.apply_manifest(cim, None) is cim


def test_quantize_params_per_site_per_channel(setup):
    """A manifest's per-site per_channel reaches quantize_weight_offline
    through the act_site scope models.quantize pushes: those sites get
    [1, M] scales, the others one scale per matrix, bit for bit the
    reference's."""
    rcfg, rp, tcfg, tp, cal = setup
    from repro.models.quantize import quantize_params as ref_qp
    from repro_torch.models.quantize import quantize_params
    man = tps.load_manifest(os.path.join(REPO, "precision_manifest.json"))
    man["sites"]["w_up"]["per_channel"] = True
    rq = ref_qp(rp, rcfg.replace(cim=rps.apply_manifest(rcfg.cim, man)))
    tq = quantize_params(tp, tcfg.replace(cim=tps.apply_manifest(tcfg.cim,
                                                                 man)))
    for i, layer in enumerate(tq["layers"]):
        for blk, name in (("ffn", "w_up"), ("ffn", "w_down"),
                          ("attn", "wq")):
            scale = layer[blk][name + "_scale"]
            assert tuple(scale.shape) == ((1, tcfg.d_ff)
                                          if name == "w_up" else (1, 1))
            assert np.array_equal(
                scale.numpy(),
                np.asarray(rq["layers"][blk][name + "_scale"][i]))
            assert np.array_equal(
                layer[blk][name + "_q"].numpy(),
                np.asarray(rq["layers"][blk][name + "_q"][i]))


def test_dispatch_energy_under_the_site_macro(setup):
    """The engine's dispatch hook charges each MVM under its site's
    resolved macro, and the per-site ADC levels reach the kernel's plain
    version unchanged (a manifest step equals one with those levels set
    uniformly at that site only)."""
    rcfg, rp, tcfg, tp, cal = setup
    from repro_torch.core.energy import mvm_energy
    from repro_torch.runtime.telemetry import KERNEL_COUNTERS
    man = tps.load_manifest(os.path.join(REPO, "precision_manifest.json"))
    cim = tps.apply_manifest(tcfg.cim, man)
    x = torch.from_numpy(np.random.RandomState(5).randn(3, 128)
                         .astype(np.float32))
    w = torch.from_numpy(np.random.RandomState(6).randn(128, 64)
                         .astype(np.float32))
    KERNEL_COUNTERS.reset()
    with quant.act_site("wv"):
        y = tcim.cim_matmul(x, w, cim)
    site = KERNEL_COUNTERS.snapshot()["site_energy"]["wv"]
    macro_181 = dataclasses.replace(tcfg.cim.macro, adc_levels=181)
    assert site["calls"] == 1 and site["dots"] == 3 * 64
    assert site["energy_j"] == pytest.approx(
        mvm_energy(macro_181, 128).e_mvm_j * 3 * 64, rel=1e-12)
    one_site = dataclasses.replace(
        cim, site_overrides=(), macro=macro_181,
        act=dataclasses.replace(cim.act, static_scale=man["sites"]["wv"][
            "act_scale"], static_zero_point=man["sites"]["wv"][
            "act_zero_point"]))
    assert torch.equal(y, tcim.cim_matmul(x, w, one_site))
