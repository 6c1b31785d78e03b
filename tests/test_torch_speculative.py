"""Seeded sampling and speculative decoding of the port
(`runtime/speculative.py`, a copy of the reference's, and the Server's
C = spec_k + 1 verify step) against the reference.

The primitives must give the reference's token and accept flag for the
same logits rows (both are host-side float64 numpy with the same Philox
keys), and raise on the same bad inputs. The Server legs run the
reference's own `_mixed_requests` schedule (tests/test_speculative.py:
RandomState 31, five requests, one with max_new 1 whose spec k clamps to
0) in the float32 smoke model on the reference's weights: token streams
and the spec metrics must EQUAL the reference's. At --cim off greedy spec
decoding must also equal plain greedy, and a sampled request decoded alone
must give the stream it gave in the batch (draws keyed by seed and
emission index). Under CIM a verify step quantizes on another grid than a
decode step (the dynamic scale spans [B, C, D]), so there spec is held to
the reference only.
"""
import dataclasses

import numpy as np
import pytest

from _torch_helpers import to_numpy_tree
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

from repro_torch.configs.registry import SMOKES
from repro_torch.core.cim_matmul import CIMConfig
from repro_torch.models import registry
from repro_torch.runtime import server as tserver
from repro_torch.runtime import speculative as tspec

jax = pytest.importorskip("jax")
from repro.runtime import speculative as rspec  # noqa: E402

MAX_LEN = 64
SAMPLED = dict(temperature=0.7, top_k=8)
SPEC_METRICS = ("steps", "decode_tokens", "prefill_tokens", "spec_steps",
                "draft_tokens", "draft_accepted", "accept_hist")


# ---------------------------------------------------------------------------
# SamplingParams, the drafter registry and the primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bad", [
    dict(temperature=-0.1), dict(temperature=float("nan")),
    dict(temperature=float("inf")), dict(top_k=-1), dict(top_k=2.5),
    dict(seed=-1), dict(seed=1.5)])
def test_sampling_params_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        rspec.SamplingParams(**bad)
    with pytest.raises(ValueError):
        tspec.SamplingParams(**bad)


def test_sampling_params_fields_match_reference():
    for kw in ({}, dict(temperature=0.5, top_k=3, seed=9)):
        r, t = rspec.SamplingParams(**kw), tspec.SamplingParams(**kw)
        assert dataclasses.asdict(r) == dataclasses.asdict(t)
        assert r.greedy == t.greedy


@pytest.mark.parametrize("spec", ["", "nope", "ngram:arg", "model", "model:",
                                  "model:not-a-smoke", 7])
def test_parse_drafter_rejects_what_the_reference_rejects(spec):
    with pytest.raises(ValueError):
        rspec.parse_drafter(spec)
    with pytest.raises(ValueError):
        tspec.parse_drafter(spec)


def test_drafter_registry_matches_reference():
    for spec in ("off", "ngram", "model:internlm2-1.8b"):
        assert tspec.parse_drafter(spec) == rspec.parse_drafter(spec)
    assert set(tspec._DRAFTER_REGISTRY) == set(rspec._DRAFTER_REGISTRY)
    with pytest.raises(ValueError, match="registered"):
        tspec.get_drafter("nope")
    cfg = SMOKES["internlm2-1.8b"]
    assert tspec.make_drafter("off", cfg, MAX_LEN) is None
    assert isinstance(tspec.make_drafter("ngram", cfg, MAX_LEN),
                      tspec.NGramDrafter)


@pytest.mark.parametrize("top_k", [0, 8])
@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sample_and_verify_token_match_reference(temperature, top_k):
    rng = np.random.RandomState(int(10 * temperature) + top_k)
    for seed in (0, 5, 123):
        rsp = rspec.SamplingParams(temperature=temperature, top_k=top_k,
                                   seed=seed)
        tsp = tspec.SamplingParams(temperature=temperature, top_k=top_k,
                                   seed=seed)
        for index in range(12):
            row = (2 * rng.randn(512)).astype(np.float32)
            assert tspec.sample_token(row, tsp, index) == \
                rspec.sample_token(row, rsp, index)
            # a likely draft (the mode) and an arbitrary one
            for draft in (int(np.argmax(row)), int(rng.randint(512))):
                assert tspec.verify_token(row, draft, tsp, index) == \
                    rspec.verify_token(row, draft, rsp, index)
            if not tsp.greedy:
                assert np.array_equal(tspec._probs(row, tsp),
                                      rspec._probs(row, rsp))


def test_ngram_propose_matches_reference():
    rng = np.random.RandomState(17)
    r, t = rspec.NGramDrafter(), tspec.NGramDrafter()
    for n in (1, 2, 5, 12, 40):
        for vocab in (3, 8, 512):
            stream = rng.randint(0, vocab, size=n).tolist()
            for k in (1, 3, 6):
                assert t.propose(stream, k) == r.propose(stream, k)
    assert t.propose([1, 2, 3, 1, 2, 3, 1, 2], 4) == [3, 1, 2, 3]
    with pytest.raises(ValueError):
        tspec.NGramDrafter(max_n=0)


# ---------------------------------------------------------------------------
# the Server on the reference's _mixed_requests schedule
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    from repro.configs.registry import SMOKES as REF_SMOKES
    from repro.models import registry as ref_registry
    cfg = REF_SMOKES["internlm2-1.8b"].replace(dtype="float32")
    params = ref_registry.init_params(jax.random.PRNGKey(0), cfg,
                                      max_seq=MAX_LEN)
    return params, to_numpy_tree(params)


def _mixed_requests(Req, SP, vocab, sampling=None):
    """The reference's mixed-depth schedule (tests/test_speculative.py):
    prompt lengths 3..19, max_new 1, 3, 5, 7, 9."""
    rng = np.random.RandomState(31)
    reqs = []
    for i in range(5):
        p = rng.randint(0, vocab, size=int(rng.randint(3, 20))).tolist()
        kw = {} if sampling is None else {
            "sampling": SP(**{**sampling, "seed": 100 + i})}
        reqs.append(Req(prompt=p, max_new_tokens=1 + 2 * i, **kw))
    return reqs


def _drain(srv, reqs):
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return [list(r.output) for r in reqs]


def _port(weights, cim="off", **kw):
    cfg = SMOKES["internlm2-1.8b"].replace(dtype="float32")
    if cim != "off":
        cfg = cfg.replace(cim=CIMConfig(enabled=True))
    kw = dict(dict(n_slots=2, max_len=MAX_LEN, block_size=8, prefill_chunk=4,
                   attn="exact", prequant=cim == "bp-prequant"), **kw)
    return tserver.Server(registry.params_from_numpy(weights[1], cfg,
                                                     device="cpu"),
                          cfg, tserver.ServingConfig(paged=True, **kw),
                          device="cpu")


def _ref(weights, cim="off", **kw):
    from repro.configs.registry import SMOKES as REF_SMOKES
    from repro.core.cim_matmul import CIMConfig as RefCIM
    from repro.runtime import server as rserver
    cfg = REF_SMOKES["internlm2-1.8b"].replace(dtype="float32")
    if cim != "off":
        cfg = cfg.replace(cim=RefCIM(enabled=True))
    kw = dict(dict(n_slots=2, max_len=MAX_LEN, block_size=8, prefill_chunk=4,
                   attn="exact", prequant=cim == "bp-prequant"), **kw)
    return rserver.Server(weights[0], cfg, rserver.ServingConfig(
        paged=True, telemetry=False, **kw))


def _run_both(weights, sampling=None, cim="off", **kw):
    """(reference streams, port streams, reference metrics, port metrics)
    of one leg on the mixed schedule."""
    from repro.runtime.server import Request as RReq
    ref, port = _ref(weights, cim, **kw), _port(weights, cim, **kw)
    rs = _drain(ref, _mixed_requests(RReq, rspec.SamplingParams, 512,
                                     sampling))
    ts = _drain(port, _mixed_requests(tserver.Request, tspec.SamplingParams,
                                      512, sampling))
    return rs, ts, ref.metrics.summary(), port.metrics.summary()


def _same_spec_metrics(rm, tm):
    assert {k: rm[k] for k in SPEC_METRICS} == {k: tm[k] for k in SPEC_METRICS}


@pytest.fixture(scope="module")
def plain_greedy(weights):
    return _drain(_port(weights), _mixed_requests(
        tserver.Request, tspec.SamplingParams, 512))


@pytest.mark.parametrize("spec_k", [1, 3])
def test_spec_greedy_matches_reference_and_plain(weights, plain_greedy,
                                                 spec_k):
    rs, ts, rm, tm = _run_both(weights, drafter="ngram", spec_k=spec_k)
    assert ts == rs
    _same_spec_metrics(rm, tm)
    assert tm["spec_steps"] > 0
    assert sum(tm["accept_hist"].values()) == tm["spec_steps"]
    assert ts == plain_greedy         # greedy spec decoding == plain greedy


def test_spec_greedy_prequant_kernel_matches_reference(weights):
    rs, ts, rm, tm = _run_both(weights, cim="bp-prequant", attn="kernel",
                               drafter="ngram", spec_k=3)
    assert ts == rs
    _same_spec_metrics(rm, tm)
    assert tm["spec_steps"] > 0


@pytest.mark.parametrize("drafter", ["off", "ngram"])
def test_sampled_matches_reference_and_is_composition_invariant(weights,
                                                                drafter):
    kw = {} if drafter == "off" else dict(drafter="ngram", spec_k=3)
    rs, ts, rm, tm = _run_both(weights, SAMPLED, **kw)
    assert ts == rs
    _same_spec_metrics(rm, tm)
    assert ts != _drain(_port(weights, **kw), _mixed_requests(
        tserver.Request, tspec.SamplingParams, 512,
        dict(SAMPLED, temperature=1.3)))        # the temperature is used
    # the probe request decoded alone gives the stream it gave in the batch
    probe = 3 if drafter == "off" else 4
    alone = _drain(_port(weights, **kw), [_mixed_requests(
        tserver.Request, tspec.SamplingParams, 512, SAMPLED)[probe]])
    assert alone == [ts[probe]]


@pytest.mark.parametrize("sampling", [None, SAMPLED])
def test_drafter_counters_match_reference(weights, sampling):
    """KERNEL_COUNTERS.drafter (ngram matches and fallbacks, one per
    proposed token) equals the reference's over the mixed schedule."""
    from repro.runtime.server import Request as RReq
    from repro.runtime.telemetry import KERNEL_COUNTERS as RKC
    from repro_torch.runtime.telemetry import KERNEL_COUNTERS as TKC
    kw = dict(drafter="ngram", spec_k=3)
    counts = []
    for srv, Req, SP, kc in ((_ref(weights, **kw), RReq, rspec.SamplingParams,
                              RKC),
                             (_port(weights, **kw), tserver.Request,
                              tspec.SamplingParams, TKC)):
        kc.reset()
        _drain(srv, _mixed_requests(Req, SP, 512, sampling))
        counts.append(dict(kc.drafter))
        kc.reset()
    assert counts[1] == counts[0]
    assert counts[1]["ngram_match"] > 0 and counts[1]["ngram_fallback"] > 0


def test_submit_rejects_non_sampling_params(weights):
    port = _port(weights)
    with pytest.raises(ValueError, match="SamplingParams"):
        port.submit(tserver.Request(prompt=[1, 2], max_new_tokens=2,
                                    sampling={"temperature": 1.0}))


def test_serving_config_spec_checks():
    with pytest.raises(ValueError, match="spec_k"):
        tserver.ServingConfig(spec_k=0)
    with pytest.raises(ValueError, match="unknown drafter"):
        tserver.ServingConfig(drafter="nope")
    with pytest.raises(ValueError, match="paged engine"):
        tserver.ServingConfig(drafter="ngram", paged=False)
    import argparse
    cfg = tserver.ServingConfig.from_flags(argparse.Namespace(
        paged=True, drafter="ngram", spec_k=2))
    assert (cfg.drafter, cfg.spec_k) == ("ngram", 2)


def test_serve_launcher_speculative_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--smoke", "--paged", "--requests", "2", "--max-new", "4",
                "--device", "cpu", "--drafter", "ngram", "--spec-k", "3",
                "--temperature", "0.7", "--top-k", "8"])
    out = capsys.readouterr().out
    assert "speculative: drafter=ngram spec_k=3" in out
    assert "accept_rate=" in out and "accept_hist=[" in out
