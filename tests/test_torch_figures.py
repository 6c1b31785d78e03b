"""The paper's closed-form figures in the port (`repro_torch.figures`)
against the reference's figure modules (`benchmarks/`), and the core
helpers they need (`adc_quantize(dequantize=False)`, `fake_quant_unsigned`,
`sqnr.sweep`, the `repro_torch.core` exports) against `repro.core` on the
same inputs.

Closed-form rows: fig18's voltage, temperature, gain and process rows,
fig21's voltage rows and ADC gating, Table I, fig7_9's R² and fig15_17's
DNL / INL / slope steps. Each row's name and derived field equal the
reference module's row on this tree; each value equals the reference's
within rel 1e-6 (1e-5 for the process INL spread), the tolerances
tests/test_golden_values.py pins the reference to. The ADC codes of the
Fig. 15 sweeps and the bp_mvm outputs of Figs. 7, 9 and 17 are bit-exact;
the raw INL curve agrees within INL_ATOL (torch's sin against XLA's, as in
tests/test_torch_noisy.py). The reference's modules run on the CPU; the
port's with device="cpu".
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from _torch_helpers import normalize
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as ref_core  # noqa: E402
from benchmarks import fig7_9_linearity as ref_fig7_9  # noqa: E402
from benchmarks import fig15_17_transfer as ref_fig15  # noqa: E402
from benchmarks import fig18_pvt as ref_fig18  # noqa: E402
from benchmarks import fig21_energy as ref_fig21  # noqa: E402
from benchmarks import table1_summary as ref_table1  # noqa: E402
from repro.core import adc as ref_adc  # noqa: E402
from repro.core import energy as ref_energy  # noqa: E402
from repro.core import quant as ref_quant  # noqa: E402
from repro.core import schemes as ref_schemes  # noqa: E402
from repro.core import sqnr as ref_sqnr  # noqa: E402

import repro_torch.core as core  # noqa: E402
from repro_torch.core import adc, energy, quant, sqnr  # noqa: E402
from repro_torch.core.macro import OperatingPoint, SimLevel  # noqa: E402
from repro_torch.figures import (common, fig7_9_linearity,  # noqa: E402
                                 fig15_17_transfer, fig18_pvt, fig21_energy,
                                 run, table1_summary)

RTOL = 1e-6
INL_RTOL = 1e-5
INL_ATOL = 5e-7   # LSB, the raw INL curve (tests/test_torch_noisy.py)


def _ref_macro(**kw):
    return dataclasses.replace(ref_core.PROTOTYPE, **kw)


def _port_macro(**kw):
    return dataclasses.replace(core.PROTOTYPE, **kw)


def _fields(lines):
    """[(name, derived)] of `name,us_per_call,derived` rows."""
    out = []
    for ln in lines:
        name, _, derived = ln.split(",", 2)
        out.append((name, derived))
    return out


# ---------------------------------------------------------------------------
# core exports and helpers
# ---------------------------------------------------------------------------
def test_core_exports_the_reference_names():
    assert core.__all__ == ref_core.__all__
    for name in ref_core.__all__:
        assert hasattr(core, name), name
    from repro_torch.core.cim_matmul import cim_matmul
    assert core.cim_matmul is cim_matmul


@pytest.mark.parametrize("name", ["PROTOTYPE", "GEOMETRY", "BP_IDEAL", "OFF"])
def test_core_exported_configs_equal_the_reference(name):
    assert normalize(getattr(core, name)) == normalize(getattr(ref_core, name))


@pytest.mark.parametrize("stop,num", [(32400.0, 1 << 15), (16200.0, 1 << 15),
                                      (10800.0, 1 << 15), (8100.0, 1 << 15),
                                      (1.0, 1024), (32400.0, 256),
                                      (1.0, 256)])
def test_linspace0_is_jnp_linspace(stop, num):
    """Every sweep the figures make, bit for bit."""
    got = common.linspace0(stop, num, "cpu").numpy()
    want = np.asarray(jnp.linspace(0.0, stop, num))
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_timeit_and_row(capsys):
    calls = []
    us = common.timeit(lambda v: calls.append(v), 3, warmup=2, iters=4)
    assert calls == [3] * 6 and 0 < us < 1e6
    assert common.row("x", 12.345, "k=1") == "x,12.3,k=1"
    assert capsys.readouterr().out == "x,12.3,k=1\n"


@pytest.mark.parametrize("level", ["ideal", "noisy", "full"])
@pytest.mark.parametrize("gain", [1.0, 3.0])
@pytest.mark.parametrize("bits", [(None, None), (4, 1), (1, 1)])
def test_adc_quantize_codes_and_values_bit_exact(level, gain, bits):
    """dequantize=False returns the code, dequantize=True code · lsb; no
    key, so NOISY adds nothing and FULL the INL curve. The sweep runs past
    both ends of the range (the clip)."""
    ba, bw = bits
    pm = _port_macro(gain=gain, sim_level=SimLevel(level))
    rm = _ref_macro(gain=gain, sim_level=ref_core.SimLevel(level))
    fs = pm.full_scale(ba, bw) / gain
    v = np.linspace(-0.05 * fs, 1.05 * fs, 4099).astype(np.float32)
    for deq in (False, True):
        got = adc.adc_quantize(torch.from_numpy(v), pm, act_bits_active=ba,
                               weight_bits_active=bw, dequantize=deq)
        want = ref_adc.adc_quantize(jnp.asarray(v), rm, act_bits_active=ba,
                                    weight_bits_active=bw, dequantize=deq)
        assert np.array_equal(got.numpy(), np.asarray(want)), deq
    codes = adc.adc_quantize(torch.from_numpy(v), pm, act_bits_active=ba,
                             weight_bits_active=bw, dequantize=False)
    assert float(codes.min()) == 0.0
    assert float(codes.max()) == pm.effective_adc_levels() - 1
    assert torch.equal(codes, torch.round(codes))


def _fq_inputs(bits):
    rng = np.random.RandomState(bits)
    x = (rng.uniform(-0.2, 1.2, 257) * 3.0).astype(np.float32)
    scale = np.float32(3.0 / ((1 << bits) - 1))
    return x, scale


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fake_quant_unsigned_forward_bit_exact(bits):
    x, scale = _fq_inputs(bits)
    got = quant.fake_quant_unsigned(torch.from_numpy(x), bits,
                                    torch.tensor(scale))
    want = ref_quant.fake_quant_unsigned(jnp.asarray(x), bits,
                                         jnp.asarray(scale))
    assert np.array_equal(got.numpy(), np.asarray(want))
    # a Python float scale gives the same (a true f32 division)
    assert torch.equal(quant.fake_quant_unsigned(torch.from_numpy(x), bits,
                                                 float(scale)), got)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fake_quant_unsigned_ste_gradient(bits):
    """The reference's STE: round and clip pass the cotangent straight
    through (clip_ste keeps it outside the range too), so d/dx of
    Σ c·fq(x) is c·scale/scale, bit for bit the reference's jax.grad."""
    x, scale = _fq_inputs(bits)
    c = np.random.RandomState(100 + bits).standard_normal(257) \
        .astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = quant.fake_quant_unsigned(xt, bits, torch.tensor(scale))
    (gx,) = torch.autograd.grad(torch.sum(torch.from_numpy(c) * y), xt)
    want = jax.grad(lambda v: jnp.sum(jnp.asarray(c) * ref_quant
                                      .fake_quant_unsigned(
                                          v, bits, jnp.asarray(scale))))(
        jnp.asarray(x))
    assert np.array_equal(gx.numpy(), np.asarray(want))
    out = (x / scale < 0) | (x / scale > (1 << bits) - 1)
    assert out.any() and (~out).any()
    np.testing.assert_allclose(gx.numpy(), c, rtol=1e-6)


def test_sweep_matches_the_reference_sweep():
    """The same (scheme, value) order as the reference's, the same Eq. 4
    energy (closed form); each SQNR is the port's simulate_sqnr of that
    config (its codes are the port's own draws: tests/
    test_torch_figures_drawn.py holds the SQNR batch on common codes)."""
    kw = dict(n_samples=256, batch=256, k=144, seed=3)
    base = _port_macro(adc_levels=64)
    got = sqnr.sweep(base, "n_rows", (9, 36), device="cpu", **kw)
    want = ref_sqnr.sweep(_ref_macro(adc_levels=64), "n_rows", (9, 36), **kw)
    assert [(s, v) for s, v, _ in got] == [(s, v) for s, v, _ in want]
    for (s, v, r), (_, _, rr) in zip(got, want):
        assert r.energy_per_mvm_j == pytest.approx(rr.energy_per_mvm_j,
                                                   rel=RTOL)
        assert r.tops_per_w == pytest.approx(rr.tops_per_w, rel=RTOL)
        cfg = dataclasses.replace(base, scheme=core.Scheme(s), n_rows=v)
        assert r == sqnr.simulate_sqnr(cfg, device="cpu", **kw)
        assert math.isfinite(r.sqnr_db)


# ---------------------------------------------------------------------------
# closed-form figures
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rows():
    """(port rows, reference rows) of each closed-form figure module."""
    out = {}
    for name, mod, ref in (("fig18", fig18_pvt, ref_fig18),
                           ("fig21", fig21_energy, ref_fig21),
                           ("table1", table1_summary, ref_table1),
                           ("fig7_9", fig7_9_linearity, ref_fig7_9),
                           ("fig15_17", fig15_17_transfer, ref_fig15)):
        out[name] = (_fields(mod.run(device="cpu")), _fields(ref.run()))
    return out


@pytest.mark.parametrize("name", ["fig18", "table1", "fig7_9", "fig15_17"])
def test_closed_form_rows_equal_the_reference(rows, name):
    got, want = rows[name]
    assert got == want


def test_fig21_voltage_rows_equal_the_reference(rows):
    """The five voltage rows; the three sparsity rows come from drawn codes
    (tests/test_torch_figures_drawn.py), so only their names match."""
    got, want = rows["fig21"]
    assert got[:5] == want[:5]
    assert [n for n, _ in got[5:]] == [n for n, _ in want[5:]]


@pytest.mark.parametrize("vdd", (0.65, 0.8, 0.9, 1.0, 1.2))
@pytest.mark.parametrize("temp", (-40.0, 25.0, 105.0))
@pytest.mark.parametrize("gain", (1.0, 2.0, 3.0, 4.0))
def test_fig18_sigma_e_and_levels(vdd, temp, gain):
    pm = _port_macro(gain=gain, op=OperatingPoint(vdd=vdd, temp_c=temp))
    rm = _ref_macro(gain=gain, op=ref_core.OperatingPoint(vdd=vdd,
                                                          temp_c=temp))
    assert pm.sigma_e_lsb() == pytest.approx(rm.sigma_e_lsb(), rel=RTOL)
    assert pm.sigma_e_lsb() * pm.adc_lsb() == pytest.approx(
        rm.sigma_e_lsb() * rm.adc_lsb(), rel=RTOL)
    assert pm.effective_adc_levels() == rm.effective_adc_levels()


def test_fig18_process_inl_spread():
    """8 groups × 5 chips of seeded INL instances, each instance's max |INL|
    within 1e-5 of the reference's, and within the ±1.10 LSB bound."""
    frac = common.linspace0(1.0, 256, "cpu")
    for inst in range(40):
        got = float(torch.max(torch.abs(common.inl_curve_eager(
            frac, core.PROTOTYPE.inl_amp_lsb, seed=inst))))
        want = float(jnp.max(jnp.abs(ref_adc.inl_curve(
            jnp.linspace(0, 1, 256), ref_core.PROTOTYPE.inl_amp_lsb,
            seed=inst))))
        assert got == pytest.approx(want, rel=INL_RTOL), inst
        assert got <= core.PROTOTYPE.inl_amp_lsb + 1e-6


@pytest.mark.parametrize("vdd", (0.65, 0.75, 0.9, 1.05, 1.2))
def test_fig21_voltage_sweep(vdd):
    pm = _port_macro(op=OperatingPoint(vdd=vdd))
    rm = _ref_macro(op=ref_core.OperatingPoint(vdd=vdd))
    rep, rrep = energy.mvm_energy(pm, 144), ref_energy.mvm_energy(rm, 144)
    for f in ("tops_per_w", "e_mvm_j", "e_adc_j", "e_mac_j",
              "bitwise_tops_per_w"):
        assert getattr(rep, f) == pytest.approx(getattr(rrep, f), rel=RTOL)
    assert pm.clock_hz() == pytest.approx(rm.clock_hz(), rel=RTOL)
    assert energy.macro_throughput_gops(pm) == pytest.approx(
        ref_energy.macro_throughput_gops(rm), rel=RTOL)


def test_fig21_adc_dual_threshold_gating():
    for dual in (True, False):
        assert adc.adc_energy_j(core.PROTOTYPE, dual_threshold=dual) == \
            pytest.approx(ref_adc.adc_energy_j(ref_core.PROTOTYPE,
                                               dual_threshold=dual), rel=RTOL)


def test_table1_values():
    m065 = _ref_macro(op=ref_core.OperatingPoint(vdd=0.65))
    m120 = _ref_macro(op=ref_core.OperatingPoint(vdd=1.2))
    want = {
        "memory_density_kb_mm2": ref_core.GEOMETRY.density_kb_mm2,
        "adc_bits": ref_core.PROTOTYPE.adc_bits,
        "sigma_e_lsb": ref_core.PROTOTYPE.sigma_e_lsb(),
        "parallelism": ref_core.PROTOTYPE.n_rows,
        "gops_0v65": ref_energy.macro_throughput_gops(m065),
        "gops_1v2": ref_energy.macro_throughput_gops(m120),
        "topsw_0v65": ref_energy.mvm_energy(m065, 144).tops_per_w,
        "topsw_1v2": ref_energy.mvm_energy(m120, 144).tops_per_w,
        "tops_mm2_1v2": ref_energy.compute_density_tops_mm2(m120),
        "bitwise_topsw_0v65":
            ref_energy.mvm_energy(m065, 144).bitwise_tops_per_w,
    }
    got = table1_summary.summary()
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=RTOL), k


def test_paper_anchors():
    """σ_E = 0.59 LSB at (0.9 V, 25 °C); 40.2 / 18.6 TOPS/W at 0.65 / 1.2 V
    (the anchors tests/test_golden_values.py pins the reference to)."""
    assert core.PROTOTYPE.sigma_e_lsb() == pytest.approx(0.59, rel=1e-3)
    for vdd, topsw in ((0.65, 40.2), (1.2, 18.6)):
        rep = energy.mvm_energy(_port_macro(op=OperatingPoint(vdd=vdd)), 144)
        assert rep.tops_per_w == pytest.approx(topsw, rel=0.01)


@pytest.mark.parametrize("gain", (1.0, 2.0, 3.0, 4.0))
def test_fig15_codes_bit_exact(gain):
    """The 32,768-point sweep's codes at FULL (INL, no noise), and the raw
    INL curve of the row."""
    pm = _port_macro(gain=gain, sim_level=SimLevel.FULL)
    rm = _ref_macro(gain=gain, sim_level=ref_core.SimLevel.FULL)
    got = fig15_17_transfer.transfer_codes(pm, 1 << 15, "cpu")
    want = np.asarray(ref_adc.adc_quantize(
        jnp.linspace(0.0, rm.full_scale() / gain, 1 << 15), rm,
        dequantize=False))
    assert np.array_equal(got, want)
    raw = common.inl_curve_eager(common.linspace0(1.0, 1024, "cpu"),
                                 pm.inl_amp_lsb, 0)
    ref_raw = ref_adc.inl_curve(jnp.linspace(0, 1, 1024), rm.inl_amp_lsb, 0)
    np.testing.assert_allclose(raw.numpy(), np.asarray(ref_raw), rtol=0,
                               atol=INL_ATOL)


def test_fig7_9_17_bp_mvm_bit_exact():
    """Every bp_mvm output of Figs. 7, 9 and 17 (FULL, INL only)."""
    pm = _port_macro(sim_level=SimLevel.FULL)
    rm = _ref_macro(sim_level=ref_core.SimLevel.FULL)
    xs = [2.0, 6.0, 9.0, 10.0, 14.0] + [float(c) for c in range(16)]
    for xc in sorted(set(xs)):
        x = np.full((1, 144), xc, np.float32)
        for wc in range(16):
            w = np.full((144, 1), float(wc), np.float32)
            got = fig7_9_linearity._mvm(xc, float(wc), pm, "cpu")
            want = float(ref_schemes.bp_mvm(jnp.asarray(x), jnp.asarray(w),
                                            rm)[0, 0])
            assert got == want, (xc, wc)
    assert fig15_17_transfer.weight_slopes(pm, "cpu") == [
        (float(ref_schemes.bp_mvm(jnp.full((1, 144), 14.0),
                                  jnp.full((144, 1), float(wc)), rm)[0, 0])
         - float(ref_schemes.bp_mvm(jnp.full((1, 144), 2.0),
                                    jnp.full((144, 1), float(wc)),
                                    rm)[0, 0])) / 12.0 for wc in range(16)]


@pytest.mark.parametrize("only", ["fig18", "fig21", "table1", "fig7_9",
                                  "fig15_17"])
def test_run_prints_the_reference_row_names(rows, only, capsys):
    run.main(["--only", only, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    got = _fields(lines[1:])
    assert [n for n, _ in got] == [n for n, _ in rows[only][1]]
    assert all("ERROR" not in d for _, d in got)


def test_run_reports_a_failing_module(monkeypatch, capsys):
    """A module that raises prints `<name>,nan,ERROR` and the run exits 1
    after running the rest."""
    def boom(device=None):
        raise RuntimeError("boom")
    monkeypatch.setattr(fig18_pvt, "run", boom)
    monkeypatch.setattr(run, "MODULES", [("fig18", fig18_pvt),
                                         ("table1", table1_summary)])
    with pytest.raises(SystemExit) as e:
        run.main(["--device", "cpu"])
    assert e.value.code == 1
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["name,us_per_call,derived", "fig18,nan,ERROR"]
    assert len(out) == 12 and out[-1].startswith("table1_bitwise_topsw")
