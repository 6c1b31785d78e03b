"""The port's serving telemetry (`runtime/telemetry.py`, `runtime/obs.py`,
the Server's hooks and the per-call engine counters) against the
reference's.

The reference's consistency soak (tests/test_telemetry.py: 3 slots,
max_len 32, block 4, a 10-block pool that forces preemption, chunk 4, the
ngram drafter at spec_k 2, 5 requests) runs on both Servers, each with its
own copy of the reference's FakeClock, on the same weights
(`params_from_numpy`). Tolerance is 0: the event stream, the step
snapshots, the counters, the four histograms, the JSONL file, the Chrome
trace and the Prometheus text must be identical. Two parts differ by
design and are held on the port alone: the reference counts its engine
and attention hooks at jax trace time (once per compiled shape), the port
per call, so the dispatch counts, the per-site dots and energy (and the
Chrome trace's copy of those counters) equal what the port's steps ran,
computed here from its step snapshots. Legs: no CIM with the exact
attention, and nibble-packed prequant with the kernel attention (B1 and
B3's plain versions on the CPU).

Also held to the reference: parallel samples (the fork schedule of
tests/test_prefix_sharing.py), the trie watermark sweep (the schedule of
tests/test_speculative.py), the energy model and the eager cim_matmul
counters.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_helpers import to_numpy_tree
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

from repro_torch.configs.registry import SMOKES
from repro_torch.core import energy as tenergy
from repro_torch.core.cim_matmul import CIMConfig
from repro_torch.models import registry
from repro_torch.runtime import obs as tobs
from repro_torch.runtime import server as tserver
from repro_torch.runtime import telemetry as ttel
from repro_torch.runtime.speculative import SamplingParams

jax = pytest.importorskip("jax")
from repro.runtime import obs as robs  # noqa: E402
from repro.runtime import server as rserver  # noqa: E402
from repro.runtime import telemetry as rtel  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
LEGS = {"off-exact": ("off", "exact"),
        "prequant-kernel": ("bp-prequant", "kernel")}
# the reference's Pallas backend names -> the port's
BACKENDS = {"pallas": "cuda", "pallas_packed": "cuda_packed",
            "pallas_noisy": "cuda_noisy",
            "pallas_noisy_packed": "cuda_noisy_packed"}
# Prometheus families whose values count calls in the port and compiled
# shapes in the reference
PER_CALL_FAMILIES = ("picoram_mvm_dispatch_total",
                     "picoram_attn_dispatch_total",
                     "picoram_mvm_energy_joules_total",
                     "picoram_mvm_traced_dots_total")


class FakeClock:
    """Deterministic monotonic clock: each call advances by `tick` (the
    reference test's own)."""

    def __init__(self, tick: float = 0.125):
        self.t = 0.0
        self.tick = tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t


@pytest.fixture(scope="module")
def weights():
    from repro.configs.registry import SMOKES as REF_SMOKES
    from repro.models import registry as ref_registry
    cfg = REF_SMOKES["internlm2-1.8b"].replace(dtype="float32")
    params = ref_registry.init_params(jax.random.PRNGKey(0), cfg, max_seq=32)
    return params, to_numpy_tree(params)


def _pair(weights, cim="off", **kw):
    """(reference Server, port Server), each with its own FakeClock."""
    from repro.configs.registry import SMOKES as REF_SMOKES
    from repro.core.cim_matmul import CIMConfig as RefCIM
    rcfg = REF_SMOKES["internlm2-1.8b"].replace(dtype="float32")
    tcfg = SMOKES["internlm2-1.8b"].replace(dtype="float32")
    if cim != "off":
        rcfg = rcfg.replace(cim=RefCIM(enabled=True))
        tcfg = tcfg.replace(cim=CIMConfig(enabled=True))
    kw = dict(kw, prequant=cim == "bp-prequant")
    ref = rserver.Server(weights[0], rcfg,
                         rserver.ServingConfig(paged=True, **kw),
                         telemetry=rtel.Telemetry(clock=FakeClock()))
    port = tserver.Server(
        registry.params_from_numpy(weights[1], tcfg, device="cpu"), tcfg,
        tserver.ServingConfig(paged=True, **kw),
        telemetry=ttel.Telemetry(clock=FakeClock()), device="cpu")
    return ref, port


def _drain(srv, reqs):
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return [list(r.output) for r in reqs]


# ---------------------------------------------------------------------------
# the consistency soak on both Servers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=sorted(LEGS))
def soak(request, weights):
    cim, attn = LEGS[request.param]
    ref, port = _pair(weights, cim, n_slots=3, max_len=32, block_size=4,
                      num_blocks=10, prefill_chunk=4, attn=attn,
                      drafter="ngram", spec_k=2)
    runs = []
    for srv, Req, counters in ((ref, rserver.Request, rtel.KERNEL_COUNTERS),
                               (port, tserver.Request,
                                ttel.KERNEL_COUNTERS)):
        rng = np.random.RandomState(0)
        reqs = [Req(prompt=rng.randint(0, 512, size=6 + i).tolist(),
                    max_new_tokens=8) for i in range(5)]
        counters.reset()
        runs.append((srv, _drain(srv, reqs), counters.snapshot()))
    return request.param, runs[0], runs[1]


def test_soak_streams_and_metrics_match_reference(soak):
    _, (ref, rs, _), (port, ts, _) = soak
    assert ts == rs
    assert port.metrics.preemptions >= 1 and port.metrics.spec_steps >= 1
    assert port.metrics.to_dict() == ref.metrics.to_dict()
    assert port.kv_cache_bytes() == ref.kv_cache_bytes()


def test_soak_events_snapshots_counters_match_reference(soak):
    _, (ref, _, _), (port, _, _) = soak
    rt, tt = ref.telemetry, port.telemetry
    assert [e.to_dict() for e in tt.events] == \
        [e.to_dict() for e in rt.events]
    assert [s.to_dict() for s in tt.snapshots] == \
        [s.to_dict() for s in rt.snapshots]
    assert tt.counters == rt.counters
    assert {"preempt", "resume", "spec_verify"} <= set(tt.counters)
    for name in ("ttft", "itl", "accept_len", "step_wall"):
        assert getattr(tt, name).summary() == getattr(rt, name).summary()


def test_soak_jsonl_matches_reference(soak, tmp_path):
    _, (ref, _, _), (port, _, _) = soak
    n_r = robs.write_events_jsonl(ref.telemetry, str(tmp_path / "r.jsonl"))
    n_t = tobs.write_events_jsonl(port.telemetry, str(tmp_path / "t.jsonl"))
    assert n_t == n_r
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "r.jsonl").read_text()


def test_soak_chrome_trace_matches_reference(soak, tmp_path):
    _, (ref, _, r_kc), (port, _, t_kc) = soak
    docs = [json.loads(json.dumps(m.chrome_trace(s.telemetry)))
            for m, s in ((robs, ref), (tobs, port))]
    assert tobs.validate_chrome_trace(docs[1]) == []
    kernels = [d["otherData"]["telemetry"].pop("kernel") for d in docs]
    assert docs[1] == docs[0]
    # the host-side counters agree; the per-call ones are the port's own
    for key in ("drafter", "tune_cache", "fallback_warnings"):
        assert kernels[1][key] == kernels[0][key] == r_kc[key] == t_kc[key]
    assert kernels[1]["drafter"]
    assert json.loads(json.dumps(t_kc)) == kernels[1]
    p = tmp_path / "trace.json"
    p.write_text(json.dumps(docs[1]))
    assert tobs.main([str(p)]) == 0


def _families(text: str) -> dict:
    """Prometheus text -> {family name: its lines}."""
    fams, name = {}, None
    for ln in text.splitlines():
        if ln.startswith("# HELP "):
            name = ln.split()[2]
        fams.setdefault(name, []).append(ln)
    return fams


def test_soak_prometheus_matches_reference(soak):
    leg, (ref, _, _), (port, _, t_kc) = soak
    r = _families(robs.prometheus_text(ref.telemetry, ref))
    t = _families(tobs.prometheus_text(port.telemetry, port))
    assert set(t) == set(r)
    assert {k: v for k, v in t.items() if k not in PER_CALL_FAMILIES} == \
        {k: v for k, v in r.items() if k not in PER_CALL_FAMILIES}
    # per call: one attention call per layer per step, and (under CIM) one
    # MVM per weight per layer plus the head; the dots are what each
    # step's shape ran ([B, C] rows; the head sees B rows, or B·C when the
    # verify step takes every position's logits)
    cfg = port.cfg
    snaps = list(port.telemetry.snapshots)
    steps, n_layers, b = len(snaps), cfg.n_layers, port.n_slots
    attn = "exact" if leg == "off-exact" else "kernel"
    assert t_kc["attn_dispatch"] == {attn: steps * n_layers}
    if leg == "off-exact":
        assert t_kc["backend_dispatch"] == {} and t_kc["site_energy"] == {}
        return
    assert t_kc["backend_dispatch"] == {"cuda_packed": steps
                                        * (7 * n_layers + 1)}
    kv = cfg.n_kv_heads * cfg.head_dim
    outs = {"wq": cfg.d_model, "wk": kv, "wv": kv, "wo": cfg.d_model,
            "w_gate": cfg.d_ff, "w_up": cfg.d_ff, "w_down": cfg.d_model}
    ks = {"wq": cfg.d_model, "wk": cfg.d_model, "wv": cfg.d_model,
          "wo": cfg.d_model, "w_gate": cfg.d_model, "w_up": cfg.d_model,
          "w_down": cfg.d_ff, "head": cfg.d_model}
    rows = sum(b * s.c for s in snaps)
    head_rows = sum(b * s.c if s.all_logits else b for s in snaps)
    macro = cfg.cim.macro
    want = {site: {"calls": steps * n_layers, "dots": rows * n_layers * m}
            for site, m in outs.items()}
    want["head"] = {"calls": steps, "dots": head_rows * cfg.vocab}
    for site, rec in t_kc["site_energy"].items():
        e = tenergy.mvm_energy(macro, ks[site]).e_mvm_j
        assert rec["energy_j"] == pytest.approx(e * rec["dots"], rel=1e-12)
    assert {s: {k: v[k] for k in ("calls", "dots")}
            for s, v in t_kc["site_energy"].items()} == want
    for fam in ("picoram_mvm_dispatch_total", "picoram_attn_dispatch_total"):
        assert "one per call" in t[fam][0] or "per layer call" in t[fam][0]


def test_telemetry_off_serves_identically(weights):
    tcfg = SMOKES["internlm2-1.8b"].replace(dtype="float32")
    params = registry.params_from_numpy(weights[1], tcfg, device="cpu")
    outs = []
    for on in (True, False):
        srv = tserver.Server(params, tcfg, tserver.ServingConfig(
            paged=True, n_slots=2, max_len=32, block_size=4,
            prefill_chunk=4, attn="exact", telemetry=on), device="cpu")
        rng = np.random.RandomState(1)
        reqs = [tserver.Request(prompt=rng.randint(0, 512, size=5).tolist(),
                                max_new_tokens=6) for _ in range(3)]
        outs.append(_drain(srv, reqs))
        if on:
            assert srv.telemetry.events
        else:
            assert not srv.telemetry.events and srv.telemetry.ttft.n == 0
            assert "blocks_free" in srv.metrics.to_dict()
    assert outs[0] == outs[1]
    assert tserver.ServingConfig().telemetry is True


# ---------------------------------------------------------------------------
# the engine counters and the energy model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("packed", [False, True])
def test_kernel_counters_site_energy_match_reference(packed):
    import jax.numpy as jnp
    from repro.core.cim_matmul import CIMConfig as RefCIM
    from repro.core.cim_matmul import cim_matmul as ref_mm
    from repro.core.cim_matmul import cim_matmul_prequant as ref_mm_pq
    from repro.core.quant import act_site as ref_site
    from repro.kernels.ops import pack_codes as ref_pack
    from repro_torch.core.cim_matmul import cim_matmul, cim_matmul_prequant
    from repro_torch.core.quant import act_site
    from repro_torch.kernels.ops import pack_codes
    x = np.linspace(0.0, 1.0, 2 * 16, dtype=np.float32).reshape(2, 16)
    w = np.linspace(-1.0, 1.0, 16 * 8, dtype=np.float32).reshape(16, 8)
    codes = np.random.RandomState(3).randint(0, 16, (16, 8)).astype(
        np.float32)
    snaps = []
    for counters, site, run in (
            (rtel.KERNEL_COUNTERS, ref_site, lambda: (
                ref_mm_pq(jnp.asarray(x), ref_pack(jnp.asarray(codes)),
                          jnp.float32(0.1), RefCIM(enabled=True))
                if packed else ref_mm(jnp.asarray(x), jnp.asarray(w),
                                      RefCIM(enabled=True)))),
            (ttel.KERNEL_COUNTERS, act_site, lambda: (
                cim_matmul_prequant(torch.from_numpy(x), pack_codes(
                    torch.from_numpy(codes)), torch.tensor(0.1),
                    CIMConfig(enabled=True))
                if packed else cim_matmul(torch.from_numpy(x),
                                          torch.from_numpy(w),
                                          CIMConfig(enabled=True))))):
        counters.reset()
        with site("wq"):
            run()
        snaps.append(counters.snapshot())
        counters.reset()
    ref, port = snaps
    assert port["backend_dispatch"] == {
        BACKENDS[k]: v for k, v in ref["backend_dispatch"].items()}
    assert port["backend_dispatch"] == {
        "cuda_packed" if packed else "cuda": 1}
    (r,), (t,) = ref["site_energy"].values(), port["site_energy"].values()
    assert list(port["site_energy"]) == ["wq"]
    assert (t["calls"], t["dots"]) == (r["calls"], r["dots"]) == (1, 16)
    assert t["energy_j"] == pytest.approx(r["energy_j"], rel=1e-12)
    assert t["energy_j"] > 0
    assert not ttel.KERNEL_COUNTERS.snapshot()["site_energy"]


@pytest.mark.parametrize("vdd", [0.65, 0.9, 1.2])
def test_energy_model_matches_reference(vdd):
    from repro.core import adc as radc
    from repro.core import energy as renergy
    from repro.core import macro as rmacro
    from repro_torch.core import adc as tadc
    from repro_torch.core import macro as tmacro
    assert tenergy.E_MAC_REF_J == renergy.E_MAC_REF_J
    rm = rmacro.MacroConfig(op=rmacro.OperatingPoint(vdd=vdd))
    tm = tmacro.MacroConfig(op=tmacro.OperatingPoint(vdd=vdd))
    assert tadc.adc_energy_j(tm) == radc.adc_energy_j(rm)
    assert tadc.adc_energy_j(tm, dual_threshold=False) == \
        radc.adc_energy_j(rm, dual_threshold=False)
    for k in (144, 2048, 8192):
        assert dataclasses.asdict(tenergy.mvm_energy(tm, k)) == \
            dataclasses.asdict(renergy.mvm_energy(rm, k))
    assert tenergy.macro_throughput_gops(tm) == \
        renergy.macro_throughput_gops(rm)
    assert tenergy.compute_density_tops_mm2(tm) == \
        renergy.compute_density_tops_mm2(rm)


def test_histogram_and_validator_match_reference():
    vals = np.random.RandomState(5).exponential(0.02, size=200)
    hs = [m.Histogram(m.ITL_BUCKETS) for m in (rtel, ttel)]
    for h in hs:
        h.record_many(vals[:150])
        for v in vals[150:]:
            h.record(v)
    assert hs[1].summary() == hs[0].summary()
    assert hs[1].counts == hs[0].counts
    bad = {"traceEvents": [{"ph": "B", "pid": 1, "tid": 1, "ts": 0,
                            "name": "a"},
                           {"ph": "E", "pid": 1, "tid": 1, "ts": -1,
                            "name": "b"},
                           {"ph": "Q", "ts": 0}]}
    assert tobs.validate_chrome_trace(bad) == \
        robs.validate_chrome_trace(bad)
    assert tobs.validate_chrome_trace(bad)


# ---------------------------------------------------------------------------
# parallel samples (A4b) and the trie watermark sweep (A4d)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("leg,sampling", [
    ("off-exact", None), ("off-exact", dict(temperature=0.7, top_k=8)),
    ("prequant-kernel", None)])
def test_parallel_samples_match_reference(weights, leg, sampling):
    """tests/test_prefix_sharing.py's fork schedule: an 11-token prompt
    (a partial tail block) with n_samples 3 on 4 slots; sampled clones
    draw with seed + i + 1."""
    cim, attn = LEGS[leg]
    ref, port = _pair(weights, cim, n_slots=4, max_len=64, block_size=8,
                      prefill_chunk=4, attn=attn)
    prompt = [11, 3, 8, 5, 2, 9, 14, 6, 1, 12, 4]
    outs = []
    for srv, Req, SP in ((ref, rserver.Request, rserver.SamplingParams),
                         (port, tserver.Request, SamplingParams)):
        kw = {} if sampling is None else {"sampling": SP(**sampling,
                                                         seed=4)}
        req = Req(prompt=list(prompt), max_new_tokens=5, n_samples=3, **kw)
        srv.submit(req)
        srv.run_until_drained()
        assert len(req.samples) == 2 and all(c.done for c in req.samples)
        outs.append([req.output] + [c.output for c in req.samples])
        if sampling is not None:
            assert [c.sampling.seed for c in req.samples] == [5, 6]
    assert outs[1] == outs[0]
    if sampling is None:
        assert outs[1][1] == outs[1][2] == outs[1][0]
    else:
        assert len({tuple(o) for o in outs[1]}) > 1
    assert port.metrics.cow_forks == 3
    assert port.metrics.prefix_hit_tokens == 2 * len(prompt)
    assert port.metrics.to_dict() == ref.metrics.to_dict()
    assert [e.to_dict() for e in port.telemetry.events] == \
        [e.to_dict() for e in ref.telemetry.events]


def test_parallel_samples_rejections_match_reference(weights):
    """n_samples 0, and a fork whose extra stash block overflows the pool
    (prompt 11 + 5 new = 2 blocks of 8; the pool holds 2), raise in both;
    the same request with n_samples 1 fits."""
    ref, port = _pair(weights, n_slots=2, max_len=64, block_size=8,
                      num_blocks=2, prefill_chunk=4, attn="exact")
    prompt = [11, 3, 8, 5, 2, 9, 14, 6, 1, 12, 4]
    for srv, Req in ((ref, rserver.Request), (port, tserver.Request)):
        with pytest.raises(ValueError, match="n_samples"):
            srv.submit(Req(prompt=[1, 2], max_new_tokens=2, n_samples=0))
        with pytest.raises(ValueError, match="KV blocks"):
            srv.submit(Req(prompt=list(prompt), max_new_tokens=5,
                           n_samples=2))
        srv.submit(Req(prompt=list(prompt), max_new_tokens=5))
        srv.run_until_drained()


def test_trie_watermark_sweep_matches_reference(weights):
    """tests/test_speculative.py's sweep schedule: three disjoint 16-token
    prompts on a 16-block pool with trie_watermark 0.25."""
    ref, port = _pair(weights, n_slots=2, max_len=64, block_size=8,
                      num_blocks=16, prefill_chunk=4, attn="exact",
                      trie_watermark=0.25)
    assert (port._trie_hi, port._trie_lo) == (ref._trie_hi,
                                              ref._trie_lo) == (4, 2)
    outs = []
    for srv, Req in ((ref, rserver.Request), (port, tserver.Request)):
        rng = np.random.RandomState(7)
        reqs = []
        for _ in range(3):
            p = rng.randint(0, 512, size=16).tolist()
            reqs.append(Req(prompt=p, max_new_tokens=2))
            _drain(srv, reqs[-1:])
        srv.step()                       # an idle step sweeps too
        outs.append([r.output for r in reqs])
    assert outs[1] == outs[0]
    assert port.metrics.trie_sweep_freed == ref.metrics.trie_sweep_freed > 0
    assert port.trie.cached_blocks <= port._trie_hi
    assert port.metrics.to_dict() == ref.metrics.to_dict()


@pytest.mark.parametrize("bad", [
    dict(trie_watermark=1.5), dict(trie_watermark=0.0),
    dict(trie_watermark=-0.25),
    dict(prefix_sharing=False, trie_watermark=0.5)])
def test_trie_watermark_validation_matches_reference(bad):
    kw = dict(max_len=128, block_size=16, **bad)
    with pytest.raises(ValueError, match="trie_watermark"):
        rserver.ServingConfig(paged=True, **kw)
    with pytest.raises(ValueError, match="trie_watermark"):
        tserver.ServingConfig(paged=True, **kw)


def test_trie_watermark_config_and_flags():
    import argparse
    ok = dict(max_len=128, block_size=16, drafter="ngram", spec_k=2,
              trie_watermark=0.75)
    assert rserver.ServingConfig(paged=True, **ok)
    assert tserver.ServingConfig(paged=True, **ok).trie_watermark == 0.75
    sc = tserver.ServingConfig.from_flags(argparse.Namespace(
        paged=True, trie_watermark=0.5, slots=2, max_len=32, block_size=8))
    assert (sc.trie_watermark, sc.n_slots) == (0.5, 2)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_serve_exports_and_cli_validator(tmp_path, capsys):
    from repro_torch.launch import serve
    trace, prom, events = (tmp_path / n for n in ("trace.json", "m.prom",
                                                  "ev.jsonl"))
    serve.main(["--smoke", "--paged", "--requests", "3", "--max-new", "4",
                "--n-samples", "2", "--trie-watermark", "0.5",
                "--arrival", "poisson", "--arrival-rate", "50",
                "--trace-out", str(trace), "--metrics-out", str(prom),
                "--events-out", str(events), "--device", "cpu"])
    out = capsys.readouterr().out
    for needle in ("arrival=poisson rate=50.0/s", "requests x2",
                   "kv_bytes total=", "ttft p50=", "trie_sweep_freed=",
                   "slo: ttft p50="):
        assert needle in out, needle
    assert out.count("req") >= 6
    res = subprocess.run([sys.executable, "-m", "repro_torch.runtime.obs",
                          str(trace)], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=os.path.join(
                             REPO, "src")), timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "valid" in res.stdout
    text = prom.read_text()
    assert 'picoram_events_total{kind="cow_fork"}' in text
    assert "picoram_trie_entries" in text
    kinds = {json.loads(ln)["kind"] for ln in events.read_text().splitlines()}
    assert {"submit", "admit", "retire", "step_snapshot"} <= kinds
