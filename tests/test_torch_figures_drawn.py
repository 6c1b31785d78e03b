"""The paper's figures whose rows come from drawn data or converter noise,
in the port (`repro_torch.figures`) against the reference's figure code
(`benchmarks/`), and the whole `figures.run` on the CPU.

The reference draws its task, its MLP init, its Monte-Carlo codes, its
sparse DAC codes and its converter noise with jax.random; the port draws
them with numpy seeds or torch.Generators, so these rows cannot be
bit-equal. Each is held as its kind:

  * function level, on common inputs: fig2's SQNR batch (`_sqnr_batch`,
    the port's, against the reference's cim_mvm_codes / exact_mvm_codes /
    signed_correction chain on the same codes: the per-row outputs
    bit-exact at IDEAL, the two sums within SUM_RTOL, both f32 sums of
    exact integers in different orders); fig21's `dac_energy_j` on the
    same codes and mask (rel 1e-6); `train_mlp`'s SGD from the reference's
    own initial weights on the reference's task (the parameters within
    TRAIN_RTOL of the reference's jax.grad training, measured 1.6e-6
    relative to the largest weight); `eval_accuracy` at IDEAL on the
    reference's trained weights and task (the same accuracy at Fig. 10's
    end and middle rungs, 32, 362 and 1024 levels, for WBS and BS, and in
    float);
  * statistics, converter noise: Fig. 16's RMS σ and σ_E within 4 σ of
    their difference (each σ measured on the CPU over 12 port and 6
    reference replicas of the whole figure with other seeds: RMS σ 0.0010
    / 0.0013 LSB, σ_E 0.0035 / 0.0028 LSB), and `eval_accuracy` at FULL
    with noise keys (Fig. 19) on identical weights: the mean over 8 keys
    of each package within 4 standard errors of the difference of the
    means (each draw's σ measured over 40 keys a package: nominal 0.0012,
    0.65 V 0.0055, gain 1 0.0143).

The whole `figures.run --device cpu` prints the reference's 74 row names
in order (`benchmarks.run` without its kernel bench, on this tree), each
row finite, and exits 0.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as ref_core  # noqa: E402
from benchmarks import common as ref_common  # noqa: E402
from benchmarks import fig16_noise as ref_fig16  # noqa: E402
from repro.core import dac as ref_dac  # noqa: E402
from repro.core import schemes as ref_schemes  # noqa: E402

import repro_torch.core as core  # noqa: E402
from repro_torch.core import dac, sqnr  # noqa: E402
from repro_torch.core.macro import OperatingPoint, SimLevel  # noqa: E402
from repro_torch.figures import common, fig16_noise, fig21_energy, run  # noqa

SUM_RTOL = 1e-6
DAC_RTOL = 1e-6
TRAIN_RTOL = 1e-5
# one replica's σ of each Fig. 16 statistic, (port, reference), LSB
FIG16_SIGMA = {"rms_sigma_lsb": (0.00104, 0.00130),
               "sigma_e_lsb": (0.00352, 0.00283)}
# one key's σ of the FULL accuracy, the larger of the two packages'
FIG19_SIGMA = {"nominal": 0.0012, "vdd0.65": 0.0055, "gain1": 0.0143}
FIG19_KEYS = 8

REFERENCE_ROWS = (
    ["fig1b_bp", "fig1b_wbs", "fig1b_bs"]
    + [f"fig2a_bp_N{n}" for n in (9, 18, 36, 72, 144)]
    + ["fig2a_wbs_N36", "fig2a_wbs_N144", "fig2a_bs_N144"]
    + [f"fig2b_bp_L{v}" for v in (256, 362, 1024)]
    + ["fig2b_wbs_L64", "fig2b_wbs_L256", "fig2b_bs_L32", "fig2b_bs_L64"]
    + ["fig7_shiftadd_weight_sweep", "fig9_end_to_end_input_sweep"]
    + [f"fig10_adc{b}b" for b in ("5", "6", "7", "8", "8.5", "9", "10")]
    + [f"fig15_gain{g}" for g in (1, 2, 3, 4)] + ["fig17_weight_gain_steps"]
    + ["fig16a_thermal_sigma", "fig16b_total_sigma_e"]
    + [f"fig18_vdd{v}" for v in ("0.65", "0.8", "0.9", "1", "1.2")]
    + [f"fig18_temp{t}" for t in ("-40", "25", "105")]
    + [f"fig18_gain{g}" for g in (1, 2, 3, 4)] + ["fig18_process_inl_spread"]
    + ["fig19_nominal"] + [f"fig19_vdd{v}" for v in ("0.65", "0.8", "1",
                                                     "1.2")]
    + ["fig19_temp-40", "fig19_temp105", "fig19_gain1", "fig19_gain2"]
    + [f"fig21_vdd{v}" for v in ("0.65", "0.75", "0.9", "1.05", "1.2")]
    + [f"fig21_dac_sparsity{s}" for s in ("0", "0.5", "0.9")]
    + [f"table1_{k}" for k in (
        "memory_density_kb_mm2", "adc_bits", "sigma_e_lsb", "parallelism",
        "gops_0v65", "gops_1v2", "topsw_0v65", "topsw_1v2", "tops_mm2_1v2",
        "bitwise_topsw_0v65")])


def _derived(line: str) -> dict:
    """{key: value} of a row's `k=v|k=v` field (units stripped)."""
    out = {}
    for part in line.split(",", 2)[2].split("|"):
        k, _, v = part.partition("=")
        out[k] = v.rstrip("LSBJ%")
    return out


# ---------------------------------------------------------------------------
# function level, common inputs
# ---------------------------------------------------------------------------
FIG2_CFGS = ([dict(scheme="bp", n_rows=n, adc_levels=64)
              for n in (9, 18, 36, 72, 144)]
             + [dict(scheme="wbs", n_rows=n, adc_levels=64) for n in (36, 144)]
             + [dict(scheme="bs", n_rows=144, adc_levels=64)]
             + [dict(scheme="bp", adc_levels=v) for v in (256, 362, 1024)]
             + [dict(scheme="wbs", adc_levels=v) for v in (64, 256)]
             + [dict(scheme="bs", adc_levels=v) for v in (32, 64)])


@pytest.mark.parametrize("kw", FIG2_CFGS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
@pytest.mark.parametrize("signed", [True, False])
def test_sqnr_batch_on_common_codes(kw, signed):
    """Fig. 2's 15 configurations: ŷ bit-exact, Σ y² and Σ (y − ŷ)² within
    SUM_RTOL, on numpy codes (x [512, 144] u4; w signed + 8, or u4)."""
    rng = np.random.RandomState(len(kw) * 1000 + kw.get("n_rows", 144))
    x = rng.randint(0, 16, (512, 144)).astype(np.float32)
    w = rng.randint(0, 16, (144, 1)).astype(np.float32)
    offset = 8 if signed else 0
    pm = dataclasses.replace(core.PROTOTYPE, **dict(
        kw, scheme=core.Scheme(kw["scheme"])))
    rm = dataclasses.replace(ref_core.PROTOTYPE, **dict(
        kw, scheme=ref_core.Scheme(kw["scheme"])))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    s, e = sqnr._sqnr_batch(pm, xt, wt, offset)
    y_hat = ref_schemes.cim_mvm_codes(jnp.asarray(x), jnp.asarray(w), rm)
    y_ref = ref_schemes.exact_mvm_codes(jnp.asarray(x), jnp.asarray(w))
    assert np.array_equal(core.cim_mvm_codes(xt, wt, pm).numpy(),
                          np.asarray(y_hat))
    if offset:
        zp = jnp.zeros(())
        y_hat = ref_schemes.signed_correction(y_hat, jnp.asarray(x),
                                              jnp.asarray(w), w_offset=offset,
                                              x_zero_point=zp)
        y_ref = ref_schemes.signed_correction(y_ref, jnp.asarray(x),
                                              jnp.asarray(w), w_offset=offset,
                                              x_zero_point=zp)
    assert float(s) == pytest.approx(float(jnp.sum(y_ref ** 2)),
                                     rel=SUM_RTOL)
    assert float(e) == pytest.approx(float(jnp.sum((y_ref - y_hat) ** 2)),
                                     rel=SUM_RTOL)
    assert float(e) > 0


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.9])
def test_fig21_dac_energy_on_common_codes(sparsity):
    codes = fig21_energy.sparse_codes(sparsity)
    assert codes.shape == (4096,)
    zeros = float(np.mean(codes == 0))
    assert abs(zeros - (sparsity + (1 - sparsity) / 16)) < 0.03
    got = float(dac.dac_energy_j(torch.from_numpy(codes), core.PROTOTYPE))
    want = float(ref_dac.dac_energy_j(jnp.asarray(codes), ref_core.PROTOTYPE))
    assert got == pytest.approx(want, rel=DAC_RTOL)


@pytest.fixture(scope="module")
def trained():
    """(reference task, reference params, port task, port params): the
    reference's task and training, and the port's SGD from the reference's
    initial weights on the same task."""
    task = ref_common.make_task()
    params = ref_common.train_mlp(task)
    key = jax.random.PRNGKey(100)           # benchmarks/common.py's init
    init = {"w1": jax.random.normal(key, (64, 144)) / np.sqrt(64),
            "w2": jax.random.normal(jax.random.fold_in(key, 1),
                                    (144, 16)) / np.sqrt(144)}
    pt = common.TaskData(*(torch.tensor(np.asarray(a)) for a in (
        task.x_train, task.y_train, task.x_test, task.y_test)))
    pt.y_train, pt.y_test = pt.y_train.long(), pt.y_test.long()
    pp = common.sgd({k: torch.tensor(np.asarray(v)) for k, v in init.items()},
                    pt, 300)
    return task, params, pt, pp


def test_train_mlp_from_common_init(trained):
    _, params, _, pp = trained
    for k in ("w1", "w2"):
        want = np.asarray(params[k])
        err = np.max(np.abs(pp[k].numpy() - want)) / np.max(np.abs(want))
        assert err <= TRAIN_RTOL, (k, err)


def _ref_weights(params):
    return {k: torch.tensor(np.asarray(v)) for k, v in params.items()}


@pytest.mark.parametrize("macro", [None] + [dict(adc_levels=v) for v in (
    32, 362, 1024)] + [dict(scheme="wbs"), dict(scheme="bs")],
    ids=lambda m: "float" if m is None else "-".join(map(str, m.values())))
def test_eval_accuracy_ideal_on_common_weights(trained, macro):
    task, params, pt, _ = trained
    pw = _ref_weights(params)
    if macro is None:
        pm = rm = None
    else:
        kw = dict(macro)
        sc = kw.pop("scheme", "bp")
        pm = dataclasses.replace(core.PROTOTYPE, scheme=core.Scheme(sc), **kw)
        rm = dataclasses.replace(ref_core.PROTOTYPE,
                                 scheme=ref_core.Scheme(sc), **kw)
    assert common.eval_accuracy(pw, pt, pm) == \
        ref_common.eval_accuracy(params, task, rm)


# ---------------------------------------------------------------------------
# statistics: converter noise
# ---------------------------------------------------------------------------
def test_fig16_sigmas_within_their_spread():
    rows, ref_rows = fig16_noise.run(device="cpu"), ref_fig16.run()
    got = {**_derived(rows[0]), **_derived(rows[1])}
    want = {**_derived(ref_rows[0]), **_derived(ref_rows[1])}
    for k, (sp, sr) in FIG16_SIGMA.items():
        tol = 4 * math.hypot(sp, sr)
        assert abs(float(got[k]) - float(want[k])) <= tol, (k, got, want)
    assert float(got["model"]) == pytest.approx(0.59, abs=1e-3)


@pytest.mark.parametrize("corner", sorted(FIG19_SIGMA))
def test_fig19_full_accuracy_within_its_spread(trained, corner):
    task, params, pt, _ = trained
    pw = _ref_weights(params)
    kw = {"nominal": {}, "vdd0.65": {"vdd": 0.65},
          "gain1": {"gain": 1.0}}[corner]
    gain, vdd = kw.get("gain", 3.0), kw.get("vdd", 0.9)
    pm = dataclasses.replace(core.PROTOTYPE, gain=gain,
                             op=OperatingPoint(vdd=vdd),
                             sim_level=SimLevel.FULL)
    rm = dataclasses.replace(ref_core.PROTOTYPE, gain=gain,
                             op=ref_core.OperatingPoint(vdd=vdd),
                             sim_level=ref_core.SimLevel.FULL)
    got = np.mean([common.eval_accuracy(pw, pt, pm, key=s)
                   for s in range(FIG19_KEYS)])
    want = np.mean([ref_common.eval_accuracy(params, task, rm,
                                             key=jax.random.PRNGKey(s))
                    for s in range(FIG19_KEYS)])
    tol = 4 * FIG19_SIGMA[corner] * math.sqrt(2 / FIG19_KEYS)
    assert abs(got - want) <= tol, (corner, got, want, tol)


def test_eval_accuracy_key_draws_are_seeded(trained):
    """key=s seeds the two layers' generators with 2s and 2s + 1: the same
    key gives the same accuracy, another key other draws."""
    _, params, pt, _ = trained
    pw = _ref_weights(params)
    pm = dataclasses.replace(core.PROTOTYPE, gain=1.0,
                             sim_level=SimLevel.FULL)
    accs = [common.eval_accuracy(pw, pt, pm, key=s) for s in (0, 0, 1, 2)]
    assert accs[0] == accs[1]
    assert len(set(accs[1:])) > 1


# ---------------------------------------------------------------------------
# the whole run
# ---------------------------------------------------------------------------
def test_figures_run_prints_the_reference_rows(capsys):
    run.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in lines[1:]] == REFERENCE_ROWS
    for ln in lines[1:]:
        _, us, derived = ln.split(",", 2)
        assert math.isfinite(float(us)) and "ERROR" not in derived, ln
        for v in _derived(ln).values():
            if v.startswith("["):
                vals = v.strip("[]").split(",")
            else:
                vals = [v]
            assert all(math.isfinite(float(s)) for s in vals), ln
