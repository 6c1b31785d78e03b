"""The port's slot engine (`ServingConfig(paged=False)`, the default) and
the model drafter against the reference, on the reference's weights
carried across by `params_from_numpy` and inputs from numpy seeds.

Tolerances, relative to the largest |value| of the reference's output:
  * `chunked_attention`, f32: 1e-5 (the frameworks differ in the last bits
    of exp and of the float einsum sums; measured: about 2e-7); bf16
    inputs: 1e-5 too, since scores and sums stay f32 (measured: about
    2e-7 before the output's bf16 rounding, which both sides do alike).
  * `prefill` / `decode_step` logits and caches in the float32 model:
    1e-5, as the paged step's test (measured: about 1e-6 without CIM;
    the CIM legs come out bit-identical).
  * Servers: greedy token streams and scheduler metrics must be EQUAL.
The reference runs op by op where held to a tolerance (layers unrolled,
no jit), because XLA's fusion rewrites w / s into w · (1/s); its Servers
run jitted, as they do in production.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_helpers import np32, to_numpy_tree
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import SMOKES as REF_SMOKES  # noqa: E402
from repro.core.cim_matmul import CIMConfig as RefCIM  # noqa: E402
from repro.core.macro import SimLevel as RefLevel  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.quantize import quantize_params as ref_quantize  # noqa
from repro.runtime import server as rserver  # noqa: E402
from repro.runtime import speculative as rspec  # noqa: E402
from repro.runtime import telemetry as rtel  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.core.cim_matmul import CIMConfig  # noqa: E402
from repro_torch.core.macro import SimLevel  # noqa: E402
from repro_torch.models import common, registry, transformer  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.runtime import server as tserver  # noqa: E402
from repro_torch.runtime import speculative as tspec  # noqa: E402
from repro_torch.runtime import telemetry as ttel  # noqa: E402

MAX_LEN = 64
TOL = 1e-5
# the legs of tests/test_torch_server.py: --cim off, nibble-packed
# prequant (B1), NOISY on the fly (B5) and NOISY prequant (B6)
LEGS = ("off", "bp-prequant", "bp-noisy", "noisy-prequant")
METRICS = ("steps", "decode_tokens", "prefill_tokens", "preemptions",
           "prefix_hit_tokens", "cow_forks", "stalled_prefills",
           "stalled_decodes", "spec_steps", "draft_tokens",
           "draft_accepted", "accept_hist")


class FakeClock:
    """Deterministic monotonic clock: each call advances by `tick`."""

    def __init__(self, tick: float = 0.125):
        self.t = 0.0
        self.tick = tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t


def _rel_err(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def _cfgs(cim):
    """(reference cfg, port cfg) for a leg, float32 smoke model."""
    ref = REF_SMOKES["internlm2-1.8b"].replace(dtype="float32")
    port = SMOKES["internlm2-1.8b"].replace(dtype="float32")
    if cim in ("bp-noisy", "noisy-prequant"):
        def noisy(cim_cls, level):
            c = cim_cls(enabled=True, noise_seed=0)
            return dataclasses.replace(c, macro=dataclasses.replace(
                c.macro, sim_level=level.NOISY))
        ref = ref.replace(cim=noisy(RefCIM, RefLevel))
        port = port.replace(cim=noisy(CIMConfig, SimLevel))
    elif cim != "off":
        ref = ref.replace(cim=RefCIM(enabled=True))
        port = port.replace(cim=CIMConfig(enabled=True))
    return ref, port


def _prequant(cim):
    return cim in ("bp-prequant", "noisy-prequant")


@pytest.fixture(scope="module")
def weights():
    cfg = REF_SMOKES["internlm2-1.8b"].replace(dtype="float32")
    params = ref_registry.init_params(jax.random.PRNGKey(0), cfg,
                                      max_seq=MAX_LEN)
    return params, to_numpy_tree(params)


def _servers(weights, cim="off", paged=False, ref_tel=None, port_tel=None,
             **kw):
    """(reference Server, port Server) on the same weights."""
    rcfg, tcfg = _cfgs(cim)
    kw = dict(dict(n_slots=2, max_len=MAX_LEN, prequant=_prequant(cim),
                   paged=paged), **kw)
    if paged:
        kw = dict(dict(block_size=8, prefill_chunk=4, attn="exact"), **kw)
    ref = rserver.Server(weights[0], rcfg, rserver.ServingConfig(
        telemetry=ref_tel is not None, **kw), telemetry=ref_tel)
    port = tserver.Server(
        registry.params_from_numpy(weights[1], tcfg, device="cpu"), tcfg,
        tserver.ServingConfig(telemetry=port_tel is not None, **kw),
        telemetry=port_tel, device="cpu")
    return ref, port


def _drain(srv, reqs):
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return [list(r.output) for r in reqs]


def _same_metrics(ref, port):
    r, t = ref.metrics.summary(), port.metrics.summary()
    assert {k: t[k] for k in METRICS} == {k: r[k] for k in METRICS}


# ---------------------------------------------------------------------------
# chunked attention
# ---------------------------------------------------------------------------
# (Tq, Tk, causal, q_offset, kv_valid, dtype): chunk 8 throughout
ATTN_CASES = {
    "triangular": (40, 40, True, 0, None, "float32"),
    "q_scan": (80, 80, True, 0, None, "float32"),
    "q_offset": (8, 40, True, 32, None, "float32"),
    "kv_valid": (40, 40, True, 0, 29, "float32"),
    "padded_noncausal": (21, 37, False, 0, 30, "float32"),
    "bf16": (40, 40, True, 0, None, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention_matches_reference(case):
    tq, tk, causal, q_offset, kv_valid, dtype = ATTN_CASES[case]
    rng = np.random.RandomState(11)
    q = rng.standard_normal((2, tq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, tk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, tk, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, chunk=8, q_offset=q_offset, kv_valid=kv_valid,
              triangular_max=8)
    ref = ref_common.chunked_attention(
        *(jnp.asarray(a).astype(dtype) for a in (q, k, v)), **kw)
    got = common.chunked_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        **kw)
    assert got.shape == ref.shape and got.dtype == getattr(torch, dtype)
    assert _rel_err(np32(got), np32(ref)) <= TOL


def test_chunked_attention_tensor_q_offset_takes_the_q_scan():
    """A traced (array) q_offset never takes the triangular unroll; the
    result still equals the reference's."""
    rng = np.random.RandomState(12)
    q, k, v = (rng.standard_normal((1, t, 2, 8)).astype(np.float32)
               for t in (16, 16, 16))
    kw = dict(causal=True, chunk=8, kv_valid=None, triangular_max=8)
    ref = ref_common.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_offset=jnp.asarray(0), **kw)
    got = common.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=torch.tensor(0), **kw)
    assert _rel_err(np32(got), np32(ref)) <= TOL


# ---------------------------------------------------------------------------
# prefill / decode_step, op by op
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cim", ["off", "bp-prequant", "noisy-prequant"])
def test_prefill_decode_match_reference(weights, cim):
    """Two prompts of different lengths prefilled alone and spliced into
    slots 0 and 2 of a 3-slot cache (slot 1 idle), a decode step at the
    shared position, then one at pos = max_len, where both write row
    max_len − 1 (dynamic_update_slice clamps its start)."""
    ref_cfg, cfg = _cfgs(cim)
    ref_params, params = weights[0], registry.params_from_numpy(
        weights[1], cfg, device="cpu")
    if _prequant(cim):
        ref_params = ref_quantize(ref_params, ref_cfg)
        params = quantize_params(params, cfg)
    ref_cfg = ref_cfg.replace(scan_layers=False)
    s = 24
    rng = np.random.RandomState(0)
    rc = ref_tf.init_cache(ref_cfg, 3, s)
    tc = transformer.init_cache(cfg, 3, s, device="cpu")
    for slot, n in ((0, 5), (2, 9)):
        toks = rng.randint(0, cfg.vocab, (1, n)).astype(np.int32)
        rl, rreq = ref_tf.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                                  ref_cfg, max_len=s)
        tl, treq = transformer.prefill(params,
                                       {"tokens": torch.from_numpy(toks)},
                                       cfg, max_len=s)
        assert tl.shape == (1, cfg.vocab) and tl.dtype == torch.float32
        assert _rel_err(np32(tl), np32(rl)) <= TOL
        assert treq["layers"]["k"].shape == (cfg.n_layers, 1, s,
                                             cfg.n_kv_heads, cfg.head_dim)
        rc = rserver._splice(rc, rreq, slot)
        tc = tserver._splice(tc, treq, slot)
    assert int(tc["pos"]) == int(rc["pos"]) == 9
    for pos in (9, s):
        rc["pos"] = jnp.asarray(pos, jnp.int32)
        tc["pos"] = torch.tensor(pos, dtype=torch.int32)
        toks = rng.randint(0, cfg.vocab, (3, 1)).astype(np.int32)
        rl, rc = ref_tf.decode_step(ref_params, jnp.asarray(toks), rc,
                                    ref_cfg)
        tl, tc = transformer.decode_step(params, torch.from_numpy(toks), tc,
                                         cfg)
        assert int(tc["pos"]) == int(rc["pos"]) == pos + 1
        assert _rel_err(np32(tl), np32(rl)) <= TOL
        for kv in ("k", "v"):
            assert _rel_err(np32(tc["layers"][kv]),
                            np32(rc["layers"][kv])) <= TOL
    # the write at pos = max_len landed on the last row of every slot
    assert bool((tc["layers"]["k"][:, 1, s - 1] != 0).all())


def test_prefill_longer_than_max_len_is_trimmed_at_splice(weights):
    """A prompt longer than max_len: the request cache stays unpadded
    (T rows) and the splice keeps its first max_len rows."""
    ref_cfg, cfg = _cfgs("off")
    ref_cfg = ref_cfg.replace(scan_layers=False)
    params = registry.params_from_numpy(weights[1], cfg, device="cpu")
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (1, 20))
    toks = toks.astype(np.int32)
    _, rreq = ref_tf.prefill(weights[0], {"tokens": jnp.asarray(toks)},
                             ref_cfg, max_len=16)
    _, treq = transformer.prefill(params, {"tokens": torch.from_numpy(toks)},
                                  cfg, max_len=16)
    assert treq["layers"]["k"].shape[2] == rreq["layers"]["k"].shape[2] == 20
    rc = rserver._splice(ref_tf.init_cache(ref_cfg, 2, 16), rreq, 1)
    tc = tserver._splice(transformer.init_cache(cfg, 2, 16, device="cpu"),
                         treq, 1)
    assert int(tc["pos"]) == int(rc["pos"]) == 20
    for kv in ("k", "v"):
        assert _rel_err(np32(tc["layers"][kv]), np32(rc["layers"][kv])) \
            <= TOL


def test_splice_overwrites_the_whole_row_and_casts():
    """A shorter request cache zeroes the rest of its slot's row; the
    source is cast to the cache's dtype; pos takes the max."""
    cfg = SMOKES["internlm2-1.8b"]                      # bf16 cache
    cache = transformer.init_cache(cfg, 2, 8, device="cpu")
    cache["layers"]["k"].fill_(3.0)
    cache["pos"].fill_(6)
    req = {"pos": torch.tensor(4, dtype=torch.int32),
           "layers": {n: torch.full((cfg.n_layers, 1, 5, cfg.n_kv_heads,
                                     cfg.head_dim), 0.5)
                      for n in ("k", "v")}}
    out = tserver._splice(cache, req, 1)
    k = out["layers"]["k"]
    assert k.dtype == torch.bfloat16 and int(out["pos"]) == 6
    assert bool((k[:, 1, :5] == 0.5).all()) and bool((k[:, 1, 5:] == 0).all())
    assert bool((k[:, 0] == 3.0).all())


# ---------------------------------------------------------------------------
# the slot Server against the reference's
# ---------------------------------------------------------------------------
def _mixed_depth(srv, Req):
    """The reference soak's randomized admission: requests land mid-flight
    at arbitrary depths (the shared pos dilutes the shallower slots)."""
    rng = np.random.RandomState(42)
    schedule = {0: 2, 2: 1, 3: 1, 7: 1}
    reqs, step = [], 0
    while reqs == [] or any(not r.done for r in reqs) or srv.queue:
        for _ in range(schedule.get(step, 0)):
            plen = int(rng.randint(3, 9))
            r = Req(prompt=rng.randint(0, 512, size=plen).tolist(),
                    max_new_tokens=int(rng.randint(2, 6)))
            srv.submit(r)
            reqs.append(r)
        srv.step()
        step += 1
        assert step < 200
    return [r.output for r in reqs]


@pytest.mark.parametrize("cim", LEGS)
def test_slot_server_mixed_depth_matches_reference(weights, cim):
    ref, port = _servers(weights, cim)
    assert not port.paged and tserver.ServingConfig().paged is False
    assert _mixed_depth(port, tserver.Request) == \
        _mixed_depth(ref, rserver.Request)
    _same_metrics(ref, port)
    assert port.metrics.to_dict() == {**port.metrics.summary()}
    assert port.kv_cache_bytes() == ref.kv_cache_bytes()
    assert port.flush_prefix_cache() == ref.flush_prefix_cache() == 0


def test_waves_slots_equal_paged_and_reference(weights):
    """Depth-aligned waves (the reference's test_soak_waves_vs_legacy_and_
    single): there the shared pos is every slot's own, so the port's slot
    engine, the port's paged engine and the reference's slot engine give
    the same streams."""
    rng = np.random.RandomState(3)
    waves = []
    for _ in range(4):
        n, plen, mnew = (int(rng.randint(1, 3)), int(rng.randint(3, 10)),
                         int(rng.randint(2, 7)))
        waves.append([(rng.randint(0, 512, size=plen).tolist(), mnew)
                      for _ in range(n)])
    _, port_paged = _servers(weights, paged=True, prefix_sharing=False)
    ref, port = _servers(weights)
    outs = []
    for srv, Req in ((ref, rserver.Request), (port, tserver.Request),
                     (port_paged, tserver.Request)):
        out = []
        for wave in waves:
            out += _drain(srv, [Req(prompt=list(p), max_new_tokens=m)
                                for p, m in wave])
        outs.append(out)
    assert outs[1] == outs[0]
    assert outs[2] == outs[0]
    _same_metrics(ref, port)


def test_prequant_packed_slots_match_paged_and_reference(weights):
    """The reference's test_prequant_packed_paged_matches_legacy, on the
    port: nibble-packed weights serve the same tokens through the slot
    engine as through the paged one, and as the reference's slot engine."""
    ref, port = _servers(weights, "bp-prequant", n_slots=1)
    _, port_paged = _servers(weights, "bp-prequant", paged=True, n_slots=1)
    assert port.params["layers"][0]["attn"]["wq_q"].dtype == torch.uint8
    outs = [_drain(srv, [Req(prompt=[5, 9, 2, 7], max_new_tokens=4)])
            for srv, Req in ((ref, rserver.Request), (port, tserver.Request),
                             (port_paged, tserver.Request))]
    assert outs[1] == outs[0] == outs[2]


def test_slot_metrics_share_one_clock(weights):
    """The reference's test_legacy_metrics_share_one_clock: the submit-time
    prefill counts toward prefill_tokens and wall_s (here on fake clocks,
    so both Servers' wall_s agree exactly)."""
    ref, port = _servers(weights, n_slots=1, ref_tel=rtel.Telemetry(
        clock=FakeClock()), port_tel=ttel.Telemetry(clock=FakeClock()))
    for srv, Req in ((ref, rserver.Request), (port, tserver.Request)):
        req = Req(prompt=[1, 2, 3, 4, 5], max_new_tokens=3)
        srv.submit(req)
        assert srv.metrics.prefill_tokens == 5 and srv.metrics.wall_s > 0
        srv.run_until_drained()
    m, r = port.metrics.summary(), ref.metrics.summary()
    assert m["prefill_tokens"] == 5 and m["prefill_tok_s"] > 0
    assert m == r


@pytest.mark.parametrize("case", ["max_new_one", "eos_at_prefill"])
def test_prefill_token_is_not_checked(weights, case):
    """The slot engine checks neither max_new_tokens nor eos_id on the
    token emitted at prefill: a max_new_tokens=1 request emits 2 tokens,
    and an eos_id equal to the first token does not retire it there."""
    ref, port = _servers(weights, n_slots=1)
    prompt = [4, 8, 15]
    first = _drain(ref, [rserver.Request(prompt=list(prompt),
                                         max_new_tokens=1)])[0]
    assert len(first) == 2
    kw = dict(max_new_tokens=1) if case == "max_new_one" else \
        dict(max_new_tokens=4, eos_id=first[0])
    outs = [_drain(srv, [Req(prompt=list(prompt), **kw)])[0]
            for srv, Req in ((ref, rserver.Request),
                             (port, tserver.Request))]
    assert outs[1] == outs[0]
    assert len(outs[1]) >= 2


def test_slot_telemetry_matches_reference(weights):
    """One slot schedule (3 requests on 2 slots, the third admitted when a
    slot frees) under fake clocks: events, counters, histograms, request
    timestamps and metrics identical."""
    ref, port = _servers(weights, "bp-prequant", ref_tel=rtel.Telemetry(
        clock=FakeClock()), port_tel=ttel.Telemetry(clock=FakeClock()))
    reqs = {}
    for srv, Req in ((ref, rserver.Request), (port, tserver.Request)):
        rng = np.random.RandomState(2)
        reqs[srv] = [Req(prompt=rng.randint(0, 512, size=4 + 2 * i).tolist(),
                         max_new_tokens=3 + i) for i in range(3)]
        _drain(srv, reqs[srv])
    rt, tt = ref.telemetry, port.telemetry
    assert [e.to_dict() for e in tt.events] == \
        [e.to_dict() for e in rt.events]
    assert tt.counters == rt.counters
    assert list(tt.snapshots) == list(rt.snapshots) == []
    assert {"submit", "admit", "prefill_chunk", "first_token", "decode",
            "retire"} <= set(tt.counters)
    for name in ("ttft", "itl", "accept_len", "step_wall"):
        assert getattr(tt, name).summary() == getattr(rt, name).summary()
    assert [(r.t_submit, r.t_first, r.t_done, r.output)
            for r in reqs[port]] == [(r.t_submit, r.t_first, r.t_done,
                                      r.output) for r in reqs[ref]]
    assert port.metrics.to_dict() == ref.metrics.to_dict()


# ---------------------------------------------------------------------------
# the model drafter
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def drafter_weights():
    """The reference drafter's own weights (seed 17), as its
    make_drafter("model:internlm2-1.8b") builds them."""
    d = rspec.make_drafter("model:internlm2-1.8b",
                           REF_SMOKES["internlm2-1.8b"], MAX_LEN)
    return d, to_numpy_tree(d.params)


def _port_drafter(drafter_weights):
    cfg = SMOKES["internlm2-1.8b"].replace(dtype="float32")
    return tspec.make_drafter(
        "model:internlm2-1.8b", cfg, MAX_LEN, device="cpu",
        params=registry.params_from_numpy(drafter_weights[1], cfg,
                                          device="cpu"))


def test_model_drafter_proposals_match_reference(drafter_weights):
    ref = drafter_weights[0]
    port = _port_drafter(drafter_weights)
    assert isinstance(port, tspec.ModelDrafter)
    rng = np.random.RandomState(4)
    for n, k in ((5, 4), (17, 2), (MAX_LEN, 3)):
        toks = rng.randint(0, 512, size=n).tolist()
        got = port.propose(toks, k)
        assert got == ref.propose(toks, k)
        assert all(isinstance(t, int) and 0 <= t < 512 for t in got)


def test_model_drafter_validates_like_reference():
    small = SMOKES["internlm2-1.8b"].replace(vocab=256)
    with pytest.raises(ValueError, match="vocab"):
        tspec.make_drafter("model:internlm2-1.8b", small, MAX_LEN,
                           device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        rspec.make_drafter("model:internlm2-1.8b",
                           REF_SMOKES["internlm2-1.8b"].replace(vocab=256),
                           MAX_LEN)
    d = tspec.make_drafter("model:internlm2-1.8b", SMOKES["internlm2-1.8b"],
                           MAX_LEN, device="cpu")
    assert d.cfg.dtype == "float32" and d.params["tok"]["embed"].dtype == \
        torch.float32


def _mixed_requests(Req):
    """The reference's mixed-depth spec schedule (tests/test_speculative.py):
    prompt lengths 3..19, max_new 1, 3, 5, 7, 9."""
    rng = np.random.RandomState(31)
    return [Req(prompt=rng.randint(0, 512, size=int(rng.randint(3, 20)))
                .tolist(), max_new_tokens=1 + 2 * i) for i in range(5)]


def test_spec_server_model_drafter_matches_reference(weights,
                                                     drafter_weights):
    """The reference's test_spec_decode_model_drafter_bit_identical on the
    port: the paged spec Server with drafter="model:internlm2-1.8b" at
    spec_k 2, the drafters on carried weights, gives the reference's
    streams and spec metrics, and plain greedy's streams."""
    ref, port = _servers(weights, paged=True, drafter="model:internlm2-1.8b",
                         spec_k=2)
    ref.drafter = drafter_weights[0]
    port.drafter = _port_drafter(drafter_weights)
    rs = _drain(ref, _mixed_requests(rserver.Request))
    ts = _drain(port, _mixed_requests(tserver.Request))
    assert ts == rs
    _same_metrics(ref, port)
    assert port.metrics.spec_steps > 0
    _, plain = _servers(weights, paged=True)
    assert _drain(plain, _mixed_requests(tserver.Request)) == ts


# ---------------------------------------------------------------------------
# configuration, the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bad,match", [
    (dict(drafter="ngram"), "paged engine"),
    (dict(trie_watermark=0.5), "trie_watermark"),
])
def test_slot_config_rejects_what_the_reference_rejects(bad, match):
    with pytest.raises(ValueError, match=match):
        rserver.ServingConfig(paged=False, **bad)
    with pytest.raises(ValueError, match=match):
        tserver.ServingConfig(paged=False, **bad)


def test_slot_config_skips_the_block_checks(weights):
    """block_size, num_blocks and max_len % block_size are checked only
    when paged; n_samples > 1 is rejected at submit on slots."""
    kw = dict(max_len=30, block_size=16, num_blocks=0)
    assert rserver.ServingConfig(**kw) and tserver.ServingConfig(**kw)
    with pytest.raises(ValueError, match="block_size"):
        tserver.ServingConfig(paged=True, **kw)
    ref, port = _servers(weights)
    for srv, Req in ((ref, rserver.Request), (port, tserver.Request)):
        with pytest.raises(ValueError, match="paged engine"):
            srv.submit(Req(prompt=[1, 2], n_samples=2))
        with pytest.raises(ValueError, match="empty prompt"):
            srv.submit(Req(prompt=[]))
        assert srv.queue == [] and not any(srv.slot_req)


def test_serve_launcher_slots_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--smoke", "--requests", "3", "--max-new", "3", "--cim",
                "bp-prequant", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("req") >= 3 and "engine=slots" in out
    assert "tok/s" in out and "blocks:" not in out
