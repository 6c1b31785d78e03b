"""The port's MoE FFN (`models/moe.py`, qwen2-moe-a2.7b) against the
reference's local path, on the reference's own weights carried across by
`params_from_numpy` and inputs built with numpy from a seed.

Exact (bit for bit): the padded expert count, the capacity, the slot of
every (token, choice), the top-k ids (ties to the lower expert index), the
stored expert codes and scales, and every expert-batched CIM projection:
the port's one expert-batched call (B1 / B6's expert-batched entry; its
plain version on the CPU) against the reference's `jax.vmap` of
`cim_matmul_prequant` over the expert axis, packed and int8, per-matrix
and per-channel scales, IDEAL and NOISY (noise_seed 0). Each expert runs
on its own dynamic DAC grid; one grid shared by all experts gives other
outputs.

Within a stated tolerance: where the two frameworks' float ops differ in
the last bit. torch's exp differs from XLA's in about one value in ten
(the softmax of the router), its SiLU and sigmoid in some, and XLA:CPU
sums the router's and the shared gate's f32 dots in four FMA lanes where
torch runs one chain. So the routing weights are held to WEIGHT_RTOL and
`moe.apply` / `_expert_ffn` to APPLY_RTOL of the output's largest
magnitude (measured up to 1.9e-7). Whole servers must give the
reference's greedy streams (tests/test_torch_server.py's schedule).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_helpers import np32, to_numpy_tree
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.analysis import calibrate as rcal  # noqa: E402
from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs.registry import SMOKES as REF_SMOKES  # noqa: E402
from repro.core.cim_matmul import CIMConfig as RefCIM  # noqa: E402
from repro.core.cim_matmul import cim_matmul_prequant as ref_prequant  # noqa
from repro.core.engine import PackedCodes as RefPacked  # noqa: E402
from repro.core.macro import SimLevel as RefLevel  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.quantize import quantize_params as ref_quantize  # noqa
from repro.runtime import server as rserver  # noqa: E402
from repro_torch.analysis import calibrate as tcal  # noqa: E402
from repro_torch.configs.registry import ARCHS, SMOKES  # noqa: E402
from repro_torch.core.cim_matmul import (CIMConfig,  # noqa: E402
                                         cim_matmul_prequant)
from repro_torch.core.engine import PackedCodes  # noqa: E402
from repro_torch.core.macro import SimLevel  # noqa: E402
from repro_torch.kernels import build, cim_mvm  # noqa: E402
from repro_torch.models import moe, registry, transformer  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.runtime import server as tserver  # noqa: E402

ARCH = "qwen2-moe-a2.7b"
MAX_LEN = 64
# the routing weights (softmax of the router, renormalized): torch's exp
# differs from XLA's in the last bit; measured max relative gap 9.7e-8
# (the probabilities 1.3e-7)
WEIGHT_RTOL = 1e-6
# moe.apply and the expert FFN, relative to the output's largest |value|:
# measured 1.3e-7 to 1.9e-7 for apply (the routing weights and the shared
# gate), 0 to 9.7e-8 for the expert FFN (SiLU moves e_down's dynamic
# grid by an ulp; NOISY prequant came out bit-identical)
APPLY_RTOL = 1e-6
# e_down's calibrated range: one f32 ulp (tests/test_torch_calibrate.py)
SPAN_RTOL = 1e-6
LEGS = ("off", "bp", "prequant", "int8", "per-channel", "noisy-prequant")


def _cims(leg):
    """(reference CIMConfig, port CIMConfig) of a leg; None for "off"."""
    if leg == "off":
        return None, None
    out = []
    for cim_cls, level in ((RefCIM, RefLevel), (CIMConfig, SimLevel)):
        if leg == "noisy-prequant":
            cim = cim_cls(enabled=True, noise_seed=0)
            cim = dataclasses.replace(cim, macro=dataclasses.replace(
                cim.macro, sim_level=level.NOISY))
        else:
            cim = cim_cls(enabled=True)
        if leg == "per-channel":
            cim = dataclasses.replace(cim, weight=dataclasses.replace(
                cim.weight, per_channel=True))
        out.append(cim)
    return tuple(out)


def _cfgs(leg, dtype="float32"):
    ref = REF_SMOKES[ARCH].replace(dtype=dtype)
    port = SMOKES[ARCH].replace(dtype=dtype)
    rc, tc = _cims(leg)
    if rc is not None:
        ref, port = ref.replace(cim=rc), port.replace(cim=tc)
    return ref, port


@pytest.fixture(scope="module")
def weights():
    cfg = REF_SMOKES[ARCH].replace(dtype="float32")
    params = ref_registry.init_params(jax.random.PRNGKey(0), cfg,
                                      max_seq=MAX_LEN)
    return params, to_numpy_tree(params)


def _ffn_params(weights, leg, layer=0):
    """Layer `layer`'s FFN params, reference and port, quantized as the
    leg serves them."""
    ref_cfg, cfg = _cfgs(leg)
    rp = jax.tree.map(lambda a: a[layer], weights[0]["layers"]["ffn"])
    tp = registry.params_from_numpy(weights[1], cfg,
                                    device="cpu")["layers"][layer]["ffn"]
    if leg not in ("off", "bp"):
        packed = leg != "int8"
        rp = ref_quantize(rp, ref_cfg, packed=packed)
        tp = quantize_params(tp, cfg, packed=packed)
    return ref_cfg, rp, cfg, tp


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------
def test_padded_experts_and_capacity():
    assert moe.EP_PAD == ref_moe.EP_PAD
    assert (moe.padded_experts(60), moe.padded_experts(8)) == (64, 16)
    for n in range(1, 70):
        assert moe.padded_experts(n) == ref_moe.padded_experts(n)
    for arch_cfgs in ((REF_SMOKES[ARCH], SMOKES[ARCH]),
                      (REF_ARCHS[ARCH], ARCHS[ARCH])):
        for t in (1, 4, 16, 20, 64, 100, 256, 1000):
            assert moe._capacity(t, arch_cfgs[1]) \
                == ref_moe._capacity(t, arch_cfgs[0])
    # full width: 8 at the paged decode (T = 4) and at a 16-token prefill
    # chunk of 4 lanes (T = 64)
    assert moe._capacity(4, ARCHS[ARCH]) == moe._capacity(64, ARCHS[ARCH]) \
        == 8


def _route_both(logits, top_k):
    """Route one-hot tokens, so that both frameworks see these logits
    exactly: token i is row i of the identity, the router is `logits`
    transposed."""
    t, e = logits.shape
    x2 = np.eye(t, dtype=np.float32)
    r = ref_moe._route(jnp.asarray(x2), jnp.asarray(logits), top_k)
    p = moe._route(torch.from_numpy(x2), torch.from_numpy(logits), top_k)
    return [np.asarray(a) for a in r], [a.numpy() for a in p]


def test_route_matches_reference():
    rng = np.random.RandomState(0)
    logits = rng.standard_normal((32, 60)).astype(np.float32)
    (rp, ri, rw), (tp, ti, tw) = _route_both(logits, 4)
    assert np.array_equal(ri, ti)
    assert np.abs(tw - rw).max() <= WEIGHT_RTOL * np.abs(rw).max()
    assert np.abs(tp - rp).max() <= WEIGHT_RTOL * np.abs(rp).max()


def test_route_ties_go_to_the_lower_index():
    """Equal logits: lax.top_k takes the lower expert index first, and
    exp(0) = 1 makes the weights exact in both frameworks."""
    logits = np.zeros((6, 8), np.float32)
    logits[1, [2, 5, 7]] = 1.0                 # three equal leaders
    logits[2, [0, 3]] = -1.0                   # ties among the rest
    logits[3] = [0.5, 0.25, 0.5, 0.25, 0.5, 0.25, 0.5, 0.25]
    logits[4, 6] = 2.0
    logits[5] = np.float32(0.3)
    (rp, ri, rw), (tp, ti, tw) = _route_both(logits, 2)
    assert np.array_equal(ri, ti)
    assert ti[0].tolist() == [0, 1] and ti[1].tolist() == [2, 5]
    assert ti[3].tolist() == [0, 2] and ti[4].tolist() == [6, 0]
    assert np.array_equal(rw[[0, 5]], tw[[0, 5]])


def test_positions_in_expert_matches_reference():
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 16, size=200).astype(np.int32)
    r = np.asarray(ref_moe._positions_in_expert(jnp.asarray(ids), 16))
    t = moe._positions_in_expert(torch.from_numpy(ids).long(), 16)
    assert np.array_equal(r, t.numpy())


# ---------------------------------------------------------------------------
# the expert-batched CIM projection
# ---------------------------------------------------------------------------
def _expert_buffer(e, c, k, seed=2):
    """[E, C, K] activations whose experts' ranges differ (expert e scaled
    by e + 1, a few experts all positive), the last rows zero as in a
    partly filled capacity buffer."""
    rng = np.random.RandomState(seed)
    buf = rng.standard_normal((e, c, k)) * (1 + np.arange(e))[:, None, None]
    buf[::3] = np.abs(buf[::3])
    buf[:, c - 3:] = 0.0
    return buf.astype(np.float32)


@pytest.mark.parametrize("leg", ["prequant", "int8", "per-channel",
                                 "noisy-prequant"])
def test_expert_batched_mvm_bit_exact(leg):
    """One expert-batched call of the port equals the reference's vmap of
    cim_matmul_prequant over the expert axis, bit for bit; a shared
    activation grid (one scale and zero point for every expert) does
    not."""
    rc, tc = _cims(leg)
    e, c, k, n = 16, 8, 128, 64
    buf = _expert_buffer(e, c, k)
    w = (np.random.RandomState(3).standard_normal((e, k, n))
         * 0.1).astype(np.float32)
    packed = leg != "int8"
    rq = ref_quantize({"e_gate": jnp.asarray(w)},
                      REF_SMOKES[ARCH].replace(cim=rc), packed=packed)
    tq = quantize_params({"e_gate": torch.from_numpy(w)},
                         SMOKES[ARCH].replace(cim=tc), packed=packed)
    q, s = tq["e_gate_q"], tq["e_gate_scale"]
    assert np.array_equal(np.asarray(rq["e_gate_q"]), q.numpy())
    assert np.array_equal(np.asarray(rq["e_gate_scale"]), s.numpy())
    assert s.shape == ((e, 1, n) if leg == "per-channel" else (e, 1, 1))
    if packed:
        y_ref = jax.vmap(lambda xb, qq, ss: ref_prequant(
            xb, RefPacked(qq, k, ss), None, rc))(
                jnp.asarray(buf), rq["e_gate_q"], rq["e_gate_scale"])
        weights = PackedCodes(q, k, s)
        y = cim_matmul_prequant(torch.from_numpy(buf), weights, None, tc)
    else:
        y_ref = jax.vmap(lambda xb, qq, ss: ref_prequant(xb, qq, ss, rc))(
            jnp.asarray(buf), rq["e_gate_q"], rq["e_gate_scale"])
        y = cim_matmul_prequant(torch.from_numpy(buf), q, s, tc)
    assert y.shape == (e, c, n) and y.dtype == torch.float32
    assert np.array_equal(np.asarray(y_ref), y.numpy())

    # one grid for all experts: the whole buffer's range
    span = max(float(buf.max()) - min(float(buf.min()), 0.0), 1e-8)
    scale = np.float32(span) / np.float32(15.0)
    zp = float(np.round(np.clip(-buf.min() / scale, 0, 15)))
    shared = dataclasses.replace(tc, act=dataclasses.replace(
        tc.act, static_scale=float(scale), static_zero_point=zp))
    y_shared = torch.stack([
        cim_matmul_prequant(torch.from_numpy(buf[i]),
                            PackedCodes(q[i], k, s[i]) if packed else q[i],
                            None if packed else s[i], shared)
        for i in range(e)])
    assert not np.array_equal(np.asarray(y_ref), y_shared.numpy())


@pytest.mark.parametrize("leg", LEGS)
def test_expert_ffn_matches_reference(weights, leg):
    ref_cfg, rp, cfg, tp = _ffn_params(weights, leg)
    e_pad = moe.padded_experts(cfg.moe.n_experts)
    buf = _expert_buffer(e_pad, 8, cfg.d_model, seed=4) * 0.5
    wts = [moe._expert_weights(tp, n, cfg) for n in ("e_gate", "e_up",
                                                      "e_down")]
    rwts = [ref_moe._expert_weights(rp, n, ref_cfg) for n in ("e_gate",
                                                              "e_up",
                                                              "e_down")]
    if leg in ("prequant", "per-channel", "noisy-prequant"):
        assert all("pk" in w for w in wts)
    y_ref = np.asarray(ref_moe._expert_ffn(jnp.asarray(buf), *rwts, ref_cfg,
                                           False))
    y = np32(moe._expert_ffn(torch.from_numpy(buf), *wts, cfg))
    assert y.shape == y_ref.shape
    assert np.abs(y - y_ref).max() <= APPLY_RTOL * np.abs(y_ref).max()


@pytest.mark.parametrize("leg", LEGS)
def test_apply_matches_reference(weights, leg):
    ref_cfg, rp, cfg, tp = _ffn_params(weights, leg, layer=1)
    x = np.random.RandomState(5).standard_normal((4, 16, cfg.d_model)) \
        .astype(np.float32)
    y_ref, aux_ref = ref_moe.apply(rp, jnp.asarray(x), ref_cfg)
    y, aux = moe.apply(tp, torch.from_numpy(x), cfg)
    assert y.shape == x.shape and y.dtype == torch.float32
    y_ref = np.asarray(y_ref)
    assert np.abs(np32(y) - y_ref).max() <= APPLY_RTOL * np.abs(y_ref).max()
    # the load-balance loss (returned at inference too, as the reference's)
    assert abs(float(aux) - float(aux_ref)) <= APPLY_RTOL * float(aux_ref)


def test_capacity_overflow_matches_reference(weights):
    """Every token routes to experts 0 and 1 (64 tokens for a capacity of
    16): the choices past capacity are dropped, in the reference's
    order."""
    ref_cfg, rp, cfg, tp = _ffn_params(weights, "prequant")
    router = np.zeros((cfg.d_model, cfg.moe.n_experts), np.float32)
    router[0, 0], router[0, 1] = 8.0, 4.0
    rp = {**rp, "router": jnp.asarray(router)}
    tp = {**tp, "router": torch.from_numpy(router)}
    x = np.random.RandomState(6).standard_normal((4, 16, cfg.d_model)) \
        .astype(np.float32)
    x[..., 0] = np.abs(x[..., 0]) + 2.0
    cap = moe._capacity(64, cfg)
    _, ids, _ = moe._route(torch.from_numpy(x.reshape(64, -1)),
                           torch.from_numpy(router), cfg.moe.top_k)
    pos = moe._positions_in_expert(ids.reshape(-1), 16)
    assert cap == 16 and int((pos >= cap).sum()) == 2 * (64 - 16)
    y_ref, _ = ref_moe.apply(rp, jnp.asarray(x), ref_cfg)
    y = np32(moe.apply(tp, torch.from_numpy(x), cfg)[0])
    y_ref = np.asarray(y_ref)
    assert np.abs(y - y_ref).max() <= APPLY_RTOL * np.abs(y_ref).max()


@pytest.mark.parametrize("leg", ["prequant", "int8", "per-channel"])
def test_quantize_params_experts_match_reference(weights, leg):
    """Stacked [L, E, K, M] reference codes and scales, split per layer."""
    ref_cfg, cfg = _cfgs(leg)
    packed = leg != "int8"
    rq = ref_quantize(weights[0], ref_cfg, packed=packed)
    tq = quantize_params(registry.params_from_numpy(weights[1], cfg,
                                                    device="cpu"),
                         cfg, packed=packed)
    for i in range(cfg.n_layers):
        ffn = tq["layers"][i]["ffn"]
        assert ffn["router"].dtype == torch.float32     # not quantized
        assert "w_sg" in ffn["shared"] and "w_sg_q" not in ffn["shared"]
        for name in ("e_gate", "e_up", "e_down"):
            for suffix in ("_q", "_scale"):
                assert np.array_equal(
                    np.asarray(rq["layers"]["ffn"][name + suffix][i]),
                    ffn[name + suffix].numpy()), (i, name, suffix)
        assert np.array_equal(
            np.asarray(rq["layers"]["ffn"]["shared"]["w_down_q"][i]),
            ffn["shared"]["w_down_q"].numpy())


def test_first_dense_layers_raise():
    """Leading dense layers (MoEConfig.first_dense) are ported: qwen2-moe
    with one builds one dense layer of width d_ff_dense and n_layers − 1
    MoE layers, as the reference's init does, and its paged pool gets a
    "dense_layers" stack; what still raises is an arch feature without
    what it needs (here learned positions, whisper's, without max_seq, as
    the reference's init asserts)."""
    moe_cfg = dataclasses.replace(SMOKES[ARCH].moe, first_dense=1,
                                  d_ff_dense=96)
    cfg = SMOKES[ARCH].replace(moe=moe_cfg)
    ref = ref_registry.init_params(jax.random.PRNGKey(0), REF_SMOKES[
        ARCH].replace(moe=dataclasses.replace(REF_SMOKES[ARCH].moe,
                                              first_dense=1, d_ff_dense=96)))
    p = registry.init_params(cfg, device="cpu")
    assert len(p["dense_layers"]) == 1 and len(p["layers"]) == 1
    assert p["dense_layers"][0]["ffn"]["w_up"].shape \
        == ref["dense_layers"]["ffn"]["w_up"].shape[1:] == (128, 96)
    assert "router" in p["layers"][0]["ffn"]
    pools = transformer.init_paged_cache(cfg, 5, 8, device="cpu")
    assert pools["dense_layers"]["k"].shape[0] == 1
    assert pools["layers"]["k"].shape[0] == 1
    with pytest.raises(ValueError, match="max_seq"):
        registry.init_params(cfg.replace(pos_embed="learned"), device="cpu")


# ---------------------------------------------------------------------------
# whole steps and servers
# ---------------------------------------------------------------------------
def test_paged_step_bf16_layer0_pools(weights):
    """The bf16 model under packed prequant, one layer deep: layer 0's K/V
    pools (written before any bf16 nonlinearity, as
    tests/test_torch_transformer.py holds the dense model) and finite
    logits after the MoE FFN."""
    ref_cfg, cfg = _cfgs("prequant", dtype="bfloat16")
    ref_cfg, cfg = ref_cfg.replace(n_layers=1), cfg.replace(n_layers=1)
    params = ref_registry.init_params(jax.random.PRNGKey(0), ref_cfg)
    tparams = quantize_params(registry.params_from_numpy(
        to_numpy_tree(params), cfg, device="cpu"), cfg)
    params = ref_quantize(params, ref_cfg)
    tables = np.arange(1, 9, dtype=np.int32).reshape(4, 2)
    toks = np.random.RandomState(8).randint(0, cfg.vocab, (4, 8)) \
        .astype(np.int32)
    lens = np.zeros(4, np.int32)
    valid = np.array([8, 5, 0, 8], np.int32)
    ref_cache = ref_tf.init_paged_cache(ref_cfg, 9, 8)
    cache = transformer.init_paged_cache(cfg, 9, 8, device="cpu")
    _, ref_cache = jax.jit(ref_tf.paged_step, static_argnums=6)(
        params, jnp.asarray(toks), ref_cache, jnp.asarray(tables),
        jnp.asarray(lens), jnp.asarray(valid), ref_cfg)
    tl, cache = transformer.paged_step(
        tparams, torch.from_numpy(toks), cache, torch.from_numpy(tables),
        torch.from_numpy(lens), torch.from_numpy(valid), cfg)
    assert torch.isfinite(tl).all()
    for kv in ("k", "v"):
        r = np32(ref_cache["layers"][kv])[0, 1:]
        assert np.abs(np32(cache["layers"][kv])[0, 1:] - r).max() \
            <= 2e-2 * np.abs(r).max()


def _serve(srv, req_cls):
    """tests/test_torch_server.py's mixed-depth schedule."""
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
@pytest.mark.parametrize("leg", ["off", "bp", "prequant", "noisy-prequant"])
def test_servers_match_reference(weights, leg, engine, monkeypatch):
    """The port's Server gives the jitted reference Server's greedy
    streams on the float32 smoke qwen2-moe, on both engines. On CPU
    tensors the expert-batched wrappers run their plain versions and
    count no launch; at --cim bp the routed experts' float weights go
    through B2's expert-batched entry (its plain version here), once per
    projection and MoE layer of each forward."""
    ref_cfg, cfg = _cfgs(leg)
    kw = dict(n_slots=2, max_len=MAX_LEN,
              prequant=leg not in ("off", "bp"))
    if engine == "paged":
        kw.update(paged=True, block_size=8, prefill_chunk=4,
                  attn="kernel" if leg != "off" else "exact")
    ref = rserver.Server(weights[0], ref_cfg,
                         rserver.ServingConfig(telemetry=False, **kw))
    port = tserver.Server(
        registry.params_from_numpy(weights[1], cfg, device="cpu"), cfg,
        tserver.ServingConfig(**kw), device="cpu")
    calls = []
    b2e_plain = cim_mvm.cim_mvm_grouped_experts_plain
    monkeypatch.setattr(cim_mvm, "cim_mvm_grouped_experts_plain",
                        lambda *a, **k: calls.append(1) or b2e_plain(*a,
                                                                     **k))
    build.reset_launch_counts()
    out = _serve(port, tserver.Request)
    counts = build.launch_counts()
    assert out == _serve(ref, rserver.Request)
    batched = {"prequant": "cim_mvm_grouped_packed_experts",
               "noisy-prequant": "cim_mvm_grouped_noisy_packed_experts",
               "bp": "cim_mvm_grouped_experts"}
    if leg in batched:
        assert counts[batched[leg]] == 0
    if leg == "bp":     # 3 projections x n_layers MoE layers per forward
        assert len(calls) > 0 and len(calls) % (3 * cfg.n_layers) == 0
    else:
        assert calls == []


def test_calibration_records_expert_sites(weights):
    """calibrate_act_tree records the routed experts under e_gate / e_up /
    e_down (unrolled, one span per expert) with the reference's shapes,
    calls and zero points, bit for bit, and e_gate's and e_up's ranges and
    scales too. e_down reads SiLU(gate) · up, whose SiLU differs from
    XLA's in the last bit: its range and scale within SPAN_RTOL (measured
    9.5e-8, one f32 ulp of lo)."""
    ref_cfg, cfg = _cfgs("bp")
    tp = registry.params_from_numpy(weights[1], cfg, device="cpu")
    tokens = np.arange(8, dtype=np.int32).reshape(1, 8) % cfg.vocab
    r = rcal.calibrate_act_tree(weights[0], tokens, ref_cfg)
    t = tcal.calibrate_act_tree(tp, tokens, cfg)
    assert list(t["sites"]) == list(r["sites"])
    assert {"e_gate", "e_up", "e_down"} <= set(t["sites"])
    for name in ("e_gate", "e_up", "e_down"):
        te, re = t["sites"][name], r["sites"][name]
        assert te["calls"] == cfg.n_layers * moe.padded_experts(
            cfg.moe.n_experts)
        for key in ("k", "m", "rows", "calls", "zero_point"):
            assert te[key] == re[key], (name, key)
        for key in ("scale", "lo", "hi", "span"):
            if name == "e_down":
                assert te[key] == pytest.approx(re[key], rel=SPAN_RTOL)
            else:
                assert te[key] == re[key], (name, key)
