"""Static calibrated DAC grids and the Servers under a precision manifest:
the port against the reference.

The static `quantize_act` codes and zero points are held BIT-EXACT against
the reference run eagerly: the port divides by the scale as an f32 tensor
and rounds the zero point to f32, as the reference's jnp.asarray does.
Calibration runs the port's eager `transformer.forward` on the einsum
backend; its per-site k/m/rows/calls and zero points equal the
reference's, and lo/hi/span/scale agree within SPAN_RTOL (the f32 forward
differs from XLA's in the last bits of norms and RoPE). The paged and slot
Servers must give the jitted reference Server's greedy streams under (i)
the static grid, (ii) the committed `precision_manifest.json` and (iii) a
hand-written manifest with one site on the WBS scheme, one on per-channel
weight scales and one at 45 ADC levels. All on the float32 smoke config,
with the weights carried over by `params_from_numpy`. The reference's MoE
calibration case (expert sites) waits for the MoE family (ROADMAP A9).
"""
import dataclasses
import importlib
import json
import os

import numpy as np
import pytest
import torch

from _torch_helpers import to_numpy_tree
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.analysis import calibrate as rcal  # noqa: E402
from repro.configs.registry import SMOKES as REF_SMOKES  # noqa: E402
from repro.core import quant as ref_quant  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.runtime import server as rserver  # noqa: E402
from repro_torch.analysis import calibrate as tcal  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
# the module, not the function the package re-exports under its name
tcim = importlib.import_module("repro_torch.core.cim_matmul")
from repro_torch.core import quant  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.runtime import server as tserver  # noqa: E402

ref_cim = importlib.import_module("repro.core.cim_matmul")
REPO = os.path.join(os.path.dirname(__file__), "..")
MAX_LEN = 64
# lo / hi / span / scale of the calibration tree, port vs reference:
# measured max relative gap 7.5e-8 (one f32 ulp of lo and hi)
SPAN_RTOL = 1e-6


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
def cal_grids(setup):
    """The whole-model static grid, reference and port."""
    rcfg, rp, tcfg, tp, cal = setup
    return (rcal.calibrate_act_scale(rp, cal, rcfg),
            tcal.calibrate_act_scale(tp, cal, tcfg))


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------
GRIDS = [(0.25, 0.0), (0.1, 7.0), (1.1715909322102864, 7.0),
         (0.45100831985473633, 8.0), (0.3, 15.0), (1e-3, 3.0)]


@pytest.mark.parametrize("scale,zp", GRIDS)
def test_static_quantize_act_bit_exact(scale, zp):
    x = (np.random.RandomState(int(zp) + 11).randn(6, 97) * 3.0) \
        .astype(np.float32)
    x[0, :5] = [-50.0, 0.0, 2.5 * scale, 0.5 * scale, 1.5 * scale]  # ties
    rc = ref_quant.ActQuantConfig(static_scale=scale, static_zero_point=zp)
    tc = quant.ActQuantConfig(static_scale=scale, static_zero_point=zp)
    sr = ref_quant.act_scale(jnp.asarray(x), rc)
    st = quant.act_scale(torch.from_numpy(x), tc)
    assert st.dtype == torch.float32 and st.shape == ()
    assert np.float32(sr) == st.numpy()
    qr, zr = ref_quant.quantize_act(jnp.asarray(x), sr, rc)
    qt, zt = quant.quantize_act(torch.from_numpy(x), st, tc)
    assert np.array_equal(np.asarray(qr), qt.numpy())
    assert zt.dtype == torch.float32 and np.float32(zr) == zt.numpy()
    # the static grid ignores the tensor's content: other rows' codes hold
    x2 = x.copy()
    x2[0] = -1e4
    q2, _ = quant.quantize_act(torch.from_numpy(x2),
                               quant.act_scale(torch.from_numpy(x2), tc), tc)
    assert torch.equal(q2[1:], qt[1:])


def test_record_act_spans_matches_reference():
    x = np.asarray([[-1.0, 0.0, 2.0], [0.5, 3.0, 1.0]], np.float32)
    with ref_quant.record_act_spans() as r_spans:
        with ref_quant.act_site("wq"):
            ref_quant.act_scale(jnp.asarray(x), ref_quant.ActQuantConfig())
    assert not quant.recording_active()
    with quant.record_act_spans() as spans:
        assert quant.recording_active()
        with quant.act_site("wq"):
            s = quant.act_scale(torch.from_numpy(x), quant.ActQuantConfig())
        quant.annotate_recorded_shape(5)
    assert not quant.recording_active()
    assert spans == r_spans == [pytest.approx(4.0)]
    rec = spans[0]
    assert isinstance(rec, quant.SpanRecord)
    assert (rec.site, rec.lo, rec.hi, rec.k, rec.rows, rec.m) \
        == ("wq", -1.0, 3.0, 3, 2, 5)
    assert float(s) == pytest.approx(4.0 / 15)
    quant.act_scale(torch.from_numpy(x), quant.ActQuantConfig())
    assert len(spans) == 1          # recorder closed: no further captures
    with quant.record_act_spans() as outer:
        with quant.record_act_spans() as inner:
            quant.act_scale(torch.from_numpy(x), quant.ActQuantConfig())
        quant.act_scale(torch.from_numpy(x), quant.ActQuantConfig())
    assert len(inner) == 1 and len(outer) == 2


def test_calibrated_zero_point_flows_through_cim_matmul(setup):
    """A grid calibrated on the tensor the dynamic path sees gives the
    dynamic matmul bit for bit; the zp = 0 static grid clips the negative
    tail and is worse; and the port's static matmul is the reference's."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 24) - 1.0).astype(np.float32)
    w = rng.randn(24, 8).astype(np.float32)
    span = float(x.max() - min(x.min(), 0.0))
    scale, zp = tcal._grid(float(x.min()), span, 15)
    assert (scale, zp) == rcal._grid(float(x.min()), span, 15)

    def run(static_zp, mod, cim_cls, xx, ww):
        cim = cim_cls(enabled=True)
        cim = dataclasses.replace(cim, act=dataclasses.replace(
            cim.act, static_scale=scale, static_zero_point=static_zp))
        return np.asarray(mod.cim_matmul(xx, ww, cim))

    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    y_dyn = tcim.cim_matmul(xt, wt, tcim.CIMConfig(enabled=True)).numpy()
    assert np.array_equal(run(zp, tcim, tcim.CIMConfig, xt, wt), y_dyn)
    for z in (zp, 0.0):
        assert np.array_equal(
            run(z, tcim, tcim.CIMConfig, xt, wt),
            run(z, ref_cim, ref_cim.CIMConfig, jnp.asarray(x),
                jnp.asarray(w)))
    ref = x @ w
    assert np.abs(run(zp, tcim, tcim.CIMConfig, xt, wt) - ref).max() \
        < np.abs(run(0.0, tcim, tcim.CIMConfig, xt, wt) - ref).max()


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
def test_collect_spans_one_per_cim_matmul(setup):
    rcfg, rp, tcfg, tp, cal = setup
    spans = tcal.collect_act_spans(tp, cal[:1, :8], tcfg)
    assert len(spans) == tcfg.n_layers * 7
    assert all(s > 0 for s in spans)
    assert [s.site for s in spans[:7]] == ["wq", "wk", "wv", "wo", "w_up",
                                           "w_gate", "w_down"]


def test_calibrate_act_scale_matches_reference(setup, cal_grids):
    rcfg, rp, tcfg, tp, cal = setup
    r, t = cal_grids
    assert t["zero_point"] == r["zero_point"] and t["qmax"] == r["qmax"]
    assert t["scale"] == pytest.approx(r["scale"], rel=SPAN_RTOL)
    assert t["span"] == pytest.approx(r["span"], rel=SPAN_RTOL)
    assert len(t["spans"]) == len(r["spans"])
    assert [s.site for s in t["spans"]] == [s.site for s in r["spans"]]
    assert t["scale"] == pytest.approx(max(t["spans"]) / t["qmax"])
    tight = tcal.calibrate_act_scale(tp, cal, tcfg, percentile=0.5)
    tight_r = rcal.calibrate_act_scale(rp, cal, rcfg, percentile=0.5)
    assert tight["scale"] <= t["scale"]
    assert tight["scale"] == pytest.approx(tight_r["scale"], rel=SPAN_RTOL)
    with pytest.raises(ValueError):
        tcal.calibrate_act_scale(tp, cal, tcfg, percentile=0.0)
    with pytest.raises(ValueError):
        tcal.calibrate_act_scale(tp, cal, tcfg.replace(
            cim=tcim.CIMConfig(enabled=False)))


def test_calibrate_act_tree_matches_reference(setup):
    rcfg, rp, tcfg, tp, cal = setup
    r = rcal.calibrate_act_tree(rp, cal, rcfg)
    t = tcal.calibrate_act_tree(tp, cal, tcfg)
    assert list(t["sites"]) == list(r["sites"])
    assert t["qmax"] == r["qmax"]
    for name, re in r["sites"].items():
        te = t["sites"][name]
        for key in ("k", "m", "rows", "calls", "zero_point"):
            assert te[key] == re[key], (name, key)
        for key in ("lo", "hi", "span", "scale"):
            assert te[key] == pytest.approx(re[key], rel=SPAN_RTOL), \
                (name, key)
        assert te["calls"] == tcfg.n_layers
        assert te["rows"] == tcfg.n_layers * cal.size
    assert t["default"]["zero_point"] == r["default"]["zero_point"]
    for key in ("scale", "span", "lo"):
        assert t["default"][key] == pytest.approx(r["default"][key],
                                                  rel=SPAN_RTOL)


# ---------------------------------------------------------------------------
# the Servers
# ---------------------------------------------------------------------------
def _mixed_manifest(tmp_path) -> str:
    """The committed manifest with one site on the WBS scheme, one on
    per-channel weight scales and one at 45 ADC levels."""
    with open(os.path.join(REPO, "precision_manifest.json")) as f:
        man = json.load(f)
    man["sites"]["wv"]["scheme"] = "wbs"
    man["sites"]["w_up"]["per_channel"] = True
    man["sites"]["wo"]["adc_levels"] = 45
    path = str(tmp_path / "mixed.json")
    with open(path, "w") as f:
        json.dump(man, f)
    return path


def _serve(srv_cls, req_cls, srv):
    """The reference's mixed-depth schedule (tests/test_torch_server.py)."""
    rng = np.random.RandomState(42)
    schedule = {0: 2, 2: 1, 3: 1, 7: 1}
    reqs, step = [], 0
    while reqs == [] or any(not r.done for r in reqs) or srv.queue:
        for _ in range(schedule.get(step, 0)):
            plen = int(rng.randint(3, 9))
            r = req_cls(prompt=rng.randint(0, 512, size=plen).tolist(),
                        max_new_tokens=int(rng.randint(2, 6)))
            srv.submit(r)
            reqs.append(r)
        srv.step()
        step += 1
        assert step < 200
    return [r.output for r in reqs]


@pytest.mark.parametrize("engine", ["paged", "slots"])
@pytest.mark.parametrize("leg", ["static", "committed", "mixed"])
def test_server_streams_match_reference(setup, cal_grids, tmp_path, leg,
                                        engine):
    """Greedy streams of the port's Server (prequant, packed) equal the
    jitted reference Server's under the static grid and both manifests."""
    rcfg, rp, tcfg, tp, cal = setup
    r_grid = cal_grids[0]
    kw = {"static": dict(act_scale=r_grid["scale"],
                         act_zero_point=r_grid["zero_point"]),
          "committed": dict(precision_manifest=os.path.join(
              REPO, "precision_manifest.json")),
          "mixed": dict(precision_manifest=_mixed_manifest(tmp_path))}[leg]
    kw.update(n_slots=2, max_len=MAX_LEN, prequant=True)
    if engine == "paged":
        kw.update(paged=True, block_size=8, prefill_chunk=4, attn="kernel")
    ref = rserver.Server(rp, rcfg, rserver.ServingConfig(telemetry=False,
                                                         **kw))
    port = tserver.Server(tp, tcfg, tserver.ServingConfig(**kw),
                          device="cpu")
    if leg != "static":
        assert dict(port.cfg.cim.site_overrides).keys() \
            == dict(ref.cfg.cim.site_overrides).keys()
    else:
        assert port.cfg.cim.act.static_scale == r_grid["scale"]
    assert _serve(tserver.Server, tserver.Request, port) \
        == _serve(rserver.Server, rserver.Request, ref)


def test_static_scale_decouples_lane_from_batch(setup, cal_grids):
    """Under the static grid a request's greedy stream on the paged engine
    is the same served alone or beside companions (the dynamic scale spans
    the whole batched tensor and cannot give this), and equal to the
    reference's. The slot engine cannot give it under any grid: its one
    shared `pos` gives a shallower lane RoPE at the deepest lane's
    position, as in the reference, so the reference's test is paged."""
    rcfg, rp, tcfg, tp, cal = setup
    grid = cal_grids[1]
    probe = [5, 9, 2, 7, 4]
    companions = [[11, 3, 8], [1, 2, 3, 4, 5, 6]]
    kw = dict(n_slots=3, max_len=MAX_LEN, act_scale=grid["scale"],
              act_zero_point=grid["zero_point"], paged=True, block_size=8,
              prefill_chunk=4, attn="exact")

    def probe_tokens(mod, params, cfg, with_companions, **extra):
        server = mod.Server(params, cfg, mod.ServingConfig(**kw), **extra)
        req = mod.Request(prompt=list(probe), max_new_tokens=4)
        server.submit(req)
        if with_companions:
            for p in companions:
                server.submit(mod.Request(prompt=list(p), max_new_tokens=4))
        server.run_until_drained()
        return req.output

    alone = probe_tokens(tserver, tp, tcfg, False, device="cpu")
    assert alone == probe_tokens(tserver, tp, tcfg, True, device="cpu")
    assert alone == probe_tokens(rserver, rp, rcfg, True)


@pytest.mark.parametrize("field,value", [
    ("act_scale", 0.1), ("precision_manifest", "precision_manifest.json")])
def test_server_precision_options_require_cim(setup, field, value):
    rcfg, rp, tcfg, tp, cal = setup
    float_cfg = tcfg.replace(cim=tcim.CIMConfig(enabled=False))
    with pytest.raises(AssertionError):
        tserver.Server(tp, float_cfg, tserver.ServingConfig(
            n_slots=1, max_len=MAX_LEN, **{field: value}), device="cpu")
    with pytest.raises(ValueError, match="act_zero_point"):
        tserver.ServingConfig(act_zero_point=3.0)


def test_stale_manifest_serves_uniform_defaults(setup, tmp_path):
    rcfg, rp, tcfg, tp, cal = setup
    with open(os.path.join(REPO, "precision_manifest.json")) as f:
        man = json.load(f)
    path = str(tmp_path / "stale.json")
    with open(path, "w") as f:
        json.dump(dict(man, arch="some-other-arch"), f)
    with pytest.warns(UserWarning, match="precision manifest"):
        srv = tserver.Server(tp, tcfg, tserver.ServingConfig(
            n_slots=2, max_len=MAX_LEN, precision_manifest=path),
            device="cpu")
    assert srv.cfg.cim.site_overrides == () and \
        srv.cfg.cim.act.static_scale is None
    r = tserver.Request(prompt=[1, 2, 3, 4], max_new_tokens=4)
    srv.submit(r)
    srv.run_until_drained()
    assert len(r.output) == 4


def test_serve_launcher_precision_flags(capsys):
    from repro_torch.launch import serve
    base = ["--smoke", "--paged", "--requests", "2", "--max-new", "3",
            "--cim", "bp-prequant", "--device", "cpu"]
    serve.main(base + ["--act-scale", "static"])
    out = capsys.readouterr().out
    assert "calibrated static act_scale=" in out and "tok/s" in out
    serve.main(base + ["--precision-manifest",
                       os.path.join(REPO, "precision_manifest.json")])
    assert "tok/s" in capsys.readouterr().out
    for bad in (["--act-scale", "static"], ["--precision-manifest", "m"]):
        with pytest.raises(SystemExit):
            serve.main(["--smoke", "--device", "cpu", "--cim", "off"] + bad)
