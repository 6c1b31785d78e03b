"""deepseek-v3 in the port (`models/mla.py`, the leading dense layers, the
expert-batched B2 / B5) against the reference, on the reference's own
weights of the smoke config (3 layers, first_dense 1, 8 routed experts
padded to 16, top-2) carried across by `params_from_numpy`, inputs from
numpy seeds.

Exact (bit for bit): B2 / B5's expert-batched plain versions (B2e / B5e)
against the reference's `jax.vmap` of its Pallas kernels in interpret
mode; `cim_matmul` on expert-batched float weights, each expert on its
own activation grid and weight scale (matrix and per-channel), against
the reference's vmap; the Server's greedy streams at --cim off, bp and
bp-noisy.

Within a stated tolerance, relative to the largest |value| of the
reference's output: `mla.apply` (prefill and the absorbed decode),
`prefill` / `decode_step` logits and latent caches and the forward, TOL.
The float einsums, the softmax's exp and the RMSNorm's rsqrt differ from
XLA:CPU's in the last bits (measured below 1e-6); under CIM a last-bit
difference can move a DAC code, and the CIM legs are held to the same
tolerance (their outputs came out within 5.2e-7, most bit-identical). The reference runs op by op (no jit) where held to a tolerance;
its Servers run jitted, as in production.
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
from repro.core.cim_matmul import cim_matmul as ref_cim_matmul  # noqa: E402
from repro.core.macro import MacroConfig as RefMacro  # noqa: E402
from repro.core.macro import SimLevel as RefLevel  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.quantize import quantize_params as ref_quantize  # noqa
from repro.runtime import server as rserver  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.cim_matmul import CIMConfig, cim_matmul  # noqa: E402
from repro_torch.core.engine import execute_mvm  # noqa: E402
from repro_torch.core.macro import MacroConfig, SimLevel  # noqa: E402
from repro_torch.kernels import build, cim_mvm, ops  # noqa: E402
from repro_torch.models import mla, registry, transformer  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.runtime import server as tserver  # noqa: E402

ARCH = "deepseek-v3-671b"
MAX_LEN = 64
# mla.apply, prefill / decode_step logits and caches and the forward's
# hidden states, relative to the reference's largest |value|; measured:
# mla.apply up to 5.3e-7 (outputs; 0 to 5.2e-7 under CIM, the latent after
# its RMSNorm up to 4.8e-7), prefill / decode_step and forward up to
# 9.6e-7 at --cim off, 2.5e-7 under CIM
TOL = 2e-6
LEGS = ("off", "bp", "bp-noisy")


def _rel_err(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def _cims(leg):
    """(reference CIMConfig, port CIMConfig) of a leg; None for "off"."""
    if leg == "off":
        return None, None
    out = []
    for cim_cls, level in ((RefCIM, RefLevel), (CIMConfig, SimLevel)):
        cim = cim_cls(enabled=True)
        if leg == "bp-noisy":
            cim = cim_cls(enabled=True, noise_seed=0)
            cim = dataclasses.replace(cim, macro=dataclasses.replace(
                cim.macro, sim_level=level.NOISY))
        if leg == "per-channel":
            cim = dataclasses.replace(cim, weight=dataclasses.replace(
                cim.weight, per_channel=True))
        out.append(cim)
    return tuple(out)


def _cfgs(leg):
    ref = REF_SMOKES[ARCH].replace(dtype="float32")
    port = SMOKES[ARCH].replace(dtype="float32")
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


# ---------------------------------------------------------------------------
# B2e / B5e: the expert-batched dense kernels' plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [None, 0, 7])
@pytest.mark.parametrize("k", [288, 200])
def test_plain_b2e_b5e_bit_exact_vs_reference_vmap(k, seed):
    """Each expert of one expert-batched call equals the reference's vmap
    of B2 (seed None) or B5 (NOISY, seeds 0 and 7) over the expert axis,
    at a K that is a multiple of the macro depth and one that is not."""
    e, c, n = 4, 8, 48
    rng = np.random.RandomState(k + (seed or 0))
    x = rng.randint(0, 16, (e, c, k)).astype(np.float32)
    w = rng.randint(0, 16, (e, k, n)).astype(np.float32)
    x[:, c - 2:] = 0.0                      # the buffer's empty rows
    level = "ideal" if seed is None else "noisy"
    rmac = RefMacro(sim_level=RefLevel(level))
    tmac = MacroConfig(sim_level=SimLevel(level))
    if seed is None:
        y_ref = jax.vmap(lambda a, b: ref_ops.cim_mvm_pallas(
            a, b, rmac, interpret=True))(jnp.asarray(x), jnp.asarray(w))
        y = ops.cim_mvm_dense_experts(torch.from_numpy(x),
                                      torch.from_numpy(w), tmac)
    else:
        y_ref = jax.vmap(lambda a, b: ref_ops.cim_mvm_pallas_noisy(
            a, b, rmac, noise_seed=jnp.int32(seed), interpret=True))(
                jnp.asarray(x), jnp.asarray(w))
        y = ops.cim_mvm_noisy_experts(
            torch.from_numpy(x), torch.from_numpy(w), tmac,
            noise_seed=torch.tensor([seed], dtype=torch.int32))
        # every expert draws what B5 draws on its own operands
        y1 = ops.cim_mvm_noisy(torch.from_numpy(x[1]), torch.from_numpy(w[1]),
                               tmac, noise_seed=torch.tensor(
                                   [seed], dtype=torch.int32))
        assert torch.equal(y[1], y1)
    assert y.shape == (e, c, n) and y.dtype == torch.float32
    assert np.array_equal(np.asarray(y_ref), y.numpy())


def test_b2e_b5e_wrappers_count_no_cpu_launch():
    """On CPU tensors the wrappers run their plain versions and count no
    launch; both are in build.launch_counts()."""
    x = torch.zeros(2, 4, 144)
    w = torch.ones(2, 144, 8)
    build.reset_launch_counts()
    cim_mvm.cim_mvm_grouped_experts(x, w, n_rows=144, levels=362, gain=1.0,
                                    full_scale=32400.0)
    counts = build.launch_counts()
    assert counts["cim_mvm_grouped_experts"] == 0
    assert counts["cim_mvm_grouped_noisy_experts"] == 0


# ---------------------------------------------------------------------------
# cim_matmul on expert-batched float weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["matrix", "per-channel", "matrix-bf16",
                                  "noisy"])
def test_cim_matmul_per_expert_scales_match_reference_vmap(case):
    """One expert-batched cim_matmul equals the reference's vmap of
    cim_matmul over the expert axis, bit for bit: each expert's own
    activation grid and weight scale ([E, 1, 1], or [E, 1, M] per
    channel); bf16 weights are widened a few experts at a time. One
    weight scale shared by every expert gives other outputs."""
    rc, tc = _cims({"per-channel": "per-channel",
                    "noisy": "bp-noisy"}.get(case, "bp"))
    e, c, k, m = 6, 8, 200, 40
    rng = np.random.RandomState(21)
    x = (rng.standard_normal((e, c, k))
         * (1 + np.arange(e))[:, None, None]).astype(np.float32)
    x[::2] = np.abs(x[::2])
    x[:, c - 3:] = 0.0
    w = (rng.standard_normal((e, k, m))
         * (1 + np.arange(e))[:, None, None] * 0.05).astype(np.float32)
    tw = torch.from_numpy(w)
    if case == "matrix-bf16":
        tw = tw.to(torch.bfloat16)
        w = np.asarray(jnp.asarray(w).astype(jnp.bfloat16)
                       .astype(jnp.float32))
    y_ref = np.asarray(jax.vmap(lambda a, b: ref_cim_matmul(a, b, rc))(
        jnp.asarray(x), jnp.asarray(w)))
    y = cim_matmul(torch.from_numpy(x), tw, tc)
    assert y.shape == (e, c, m) and y.dtype == torch.float32
    assert np.array_equal(y_ref, y.numpy())
    s_w = quant.weight_scale(tw, tc.weight, per_expert=True)
    assert s_w.shape == ((e, 1, m) if case == "per-channel" else (e, 1, 1))

    # one weight scale over the whole stack (the 2-D reduction)
    xt = torch.from_numpy(x)
    s_x = quant.act_scale(xt, tc.act, per_expert=True)
    x_codes, zp = quant.quantize_act(xt, s_x, tc.act, per_expert=True)
    shared = quant.weight_scale(tw.float(), tc.weight)
    y_shared = execute_mvm(
        x_codes, quant.quantize_weight(tw.float(), shared, tc.weight), tc,
        s_x=s_x, s_w=shared, x_zero_point=zp)
    assert not np.array_equal(y_ref, y_shared.numpy())


def test_quantize_weight_experts_chunks_are_elementwise(monkeypatch):
    """Chunking the expert stack changes nothing: one expert per chunk
    gives the whole-stack codes."""
    rng = np.random.RandomState(22)
    w = torch.from_numpy(rng.standard_normal((5, 30, 12)).astype(np.float32))
    cfg = quant.WeightQuantConfig()
    s = quant.weight_scale(w, cfg, per_expert=True)
    whole = quant.quantize_weight(w, s, cfg)
    monkeypatch.setattr(quant, "_EXPERT_CHUNK_ELEMS", 1)
    assert torch.equal(quant.quantize_weight_experts(w, s, cfg), whole)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
def _attn_params(weights, leg):
    ref_cfg, cfg = _cfgs(leg)
    rp = jax.tree.map(lambda a: a[0], weights[0]["dense_layers"]["attn"])
    tp = registry.params_from_numpy(
        weights[1], cfg, device="cpu")["dense_layers"][0]["attn"]
    return ref_cfg, rp, cfg, tp


@pytest.mark.parametrize("leg", ["off", "bp", "bp-noisy"])
def test_mla_prefill_matches_reference(weights, leg):
    """K/V rebuilt from the latent through w_uk / w_uv, V padded to the qk
    dim, chunked attention (two chunks of 64): output and the latent
    entries."""
    ref_cfg, rp, cfg, tp = _attn_params(weights, leg)
    b, t = 2, 80
    x = np.random.RandomState(30).standard_normal((b, t, cfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(t), (b, t)).astype(np.int32)
    y_ref, e_ref = ref_mla.apply(rp, jnp.asarray(x), ref_cfg,
                                 positions=jnp.asarray(pos),
                                 return_cache=True)
    y, e = mla.apply(tp, torch.from_numpy(x), cfg,
                     positions=torch.from_numpy(pos).long(),
                     return_cache=True)
    lat = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    assert y.shape == (b, t, cfg.d_model) and e["latent"].shape == (b, t,
                                                                     lat)
    assert _rel_err(np32(y), np32(y_ref)) <= TOL
    assert _rel_err(np32(e["latent"]), np32(e_ref["latent"])) <= TOL


@pytest.mark.parametrize("leg", ["off", "bp", "bp-noisy"])
@pytest.mark.parametrize("pos", [5, MAX_LEN])
def test_mla_absorbed_decode_matches_reference(weights, leg, pos):
    """The absorbed decode over a latent cache: the new latent written at
    row pos (row S − 1 once pos reaches S, as dynamic_update_slice clamps),
    scores over rows <= pos scaled by 1/sqrt(qk dim)."""
    ref_cfg, rp, cfg, tp = _attn_params(weights, leg)
    b = 3
    lat = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    rng = np.random.RandomState(31 + pos)
    cache = rng.standard_normal((b, MAX_LEN, lat)).astype(np.float32)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    positions = np.full((b, 1), pos, np.int32)
    y_ref, c_ref = ref_mla.apply(
        rp, jnp.asarray(x), ref_cfg, positions=jnp.asarray(positions),
        cache={"latent": jnp.asarray(cache)}, cache_index=jnp.int32(pos))
    tcache = {"latent": torch.from_numpy(cache.copy())}
    y, c = mla.apply(tp, torch.from_numpy(x), cfg,
                     positions=torch.from_numpy(positions).long(),
                     cache=tcache, cache_index=torch.tensor(pos))
    assert c["latent"] is tcache["latent"]              # written in place
    assert y.shape == (b, 1, cfg.d_model)
    assert _rel_err(np32(y), np32(y_ref)) <= TOL
    assert _rel_err(np32(c["latent"]), np32(c_ref["latent"])) <= TOL
    row = min(pos, MAX_LEN - 1)
    assert not np.array_equal(np32(c["latent"])[:, row], cache[:, row])


# ---------------------------------------------------------------------------
# the model: params, prefill / decode_step, forward
# ---------------------------------------------------------------------------
def test_params_from_numpy_splits_the_stacks(weights):
    """dense_layers into first_dense dicts, layers into n_layers −
    first_dense, mtp carried; every leaf equal to the reference's."""
    cfg = SMOKES[ARCH].replace(dtype="float32")
    p = registry.params_from_numpy(weights[1], cfg, device="cpu")
    ref = weights[0]
    assert len(p["dense_layers"]) == 1 and len(p["layers"]) == 2
    assert set(p["mtp"]) == set(ref["mtp"]) == {"proj", "block", "norm_h",
                                                "norm_e"}
    assert p["dense_layers"][0]["ffn"]["w_up"].shape == (cfg.d_model, 256)
    assert "router" in p["layers"][1]["ffn"]
    assert np.array_equal(p["layers"][1]["ffn"]["e_down"].numpy(),
                          np.asarray(ref["layers"]["ffn"]["e_down"][1]))
    assert np.array_equal(p["dense_layers"][0]["attn"]["w_uk"].numpy(),
                          np.asarray(ref["dense_layers"]["attn"]["w_uk"][0]))
    assert np.array_equal(p["mtp"]["proj"]["w_proj"].numpy(),
                          np.asarray(ref["mtp"]["proj"]["w_proj"]))
    # the port's own init builds the same tree
    mine = transformer.init(cfg, seed=0, device="cpu")
    assert len(mine["dense_layers"]) == 1 and len(mine["layers"]) == 2
    assert set(mine["mtp"]["block"]["attn"]) \
        == set(p["mtp"]["block"]["attn"])


@pytest.mark.parametrize("leg", ["off", "bp-noisy"])
def test_prefill_decode_match_reference(weights, leg):
    """A 9-token prompt prefilled alone and spliced into slot 1 of a 2-slot
    latent cache (slot 0 idle), a decode step at its position, then one at
    pos = max_len (row max_len − 1). The Server test's shapes, so the
    reference's op-by-op compiles are shared."""
    ref_cfg, cfg = _cfgs(leg)
    ref_cfg = ref_cfg.replace(scan_layers=False)
    params = registry.params_from_numpy(weights[1], cfg, device="cpu")
    s = MAX_LEN
    rng = np.random.RandomState(0)
    rc = ref_tf.init_cache(ref_cfg, 2, s)
    tc = transformer.init_cache(cfg, 2, s, device="cpu")
    lat = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    assert tc["dense_layers"]["latent"].shape == (1, 2, s, lat)
    assert tc["layers"]["latent"].shape == (2, 2, s, lat)
    for slot, n in ((1, 9),):
        toks = rng.randint(0, cfg.vocab, (1, n)).astype(np.int32)
        rl, rreq = ref_tf.prefill(weights[0], {"tokens": jnp.asarray(toks)},
                                  ref_cfg, max_len=s)
        tl, treq = transformer.prefill(params,
                                       {"tokens": torch.from_numpy(toks)},
                                       cfg, max_len=s)
        assert tl.shape == (1, cfg.vocab) and tl.dtype == torch.float32
        assert _rel_err(np32(tl), np32(rl)) <= TOL
        rc = rserver._splice(rc, rreq, slot)
        tc = tserver._splice(tc, treq, slot)
    assert int(tc["pos"]) == int(rc["pos"]) == 9
    for pos in (9, s):
        rc["pos"] = jnp.asarray(pos, jnp.int32)
        tc["pos"] = torch.tensor(pos, dtype=torch.int32)
        toks = rng.randint(0, cfg.vocab, (2, 1)).astype(np.int32)
        rl, rc = ref_tf.decode_step(weights[0], jnp.asarray(toks), rc,
                                    ref_cfg)
        tl, tc = transformer.decode_step(params, torch.from_numpy(toks), tc,
                                         cfg)
        assert int(tc["pos"]) == int(rc["pos"]) == pos + 1
        assert _rel_err(np32(tl), np32(rl)) <= TOL
        for stack in ("dense_layers", "layers"):
            assert _rel_err(np32(tc[stack]["latent"]),
                            np32(rc[stack]["latent"])) <= TOL


def test_forward_matches_reference(weights):
    """The padded forward (the model drafter's and calibration's path):
    dense layers, then the MoE layers."""
    ref_cfg, cfg = _cfgs("off")
    ref_cfg = ref_cfg.replace(scan_layers=False)
    toks = np.random.RandomState(2).randint(0, cfg.vocab, (1, 9)) \
        .astype(np.int32)
    h_ref, aux_ref, _ = ref_tf.forward(
        weights[0], {"tokens": jnp.asarray(toks)}, ref_cfg, train=False)
    h, aux, enc = transformer.forward(
        registry.params_from_numpy(weights[1], cfg, device="cpu"),
        {"tokens": torch.from_numpy(toks)}, cfg, train=False)
    # the MoE layers' load-balance losses, summed as the reference sums them
    assert enc is None
    assert abs(float(aux) - float(aux_ref)) <= TOL * float(aux_ref)
    assert _rel_err(np32(h), np32(h_ref)) <= TOL


# ---------------------------------------------------------------------------
# the slot Server
# ---------------------------------------------------------------------------
def _mixed_depth(srv, req_cls, plen=None):
    """tests/test_torch_slots.py's randomized admission; `plen` fixes every
    prompt's length (the draws stay the same)."""
    rng = np.random.RandomState(42)
    schedule = {0: 2, 2: 1, 3: 1, 7: 1}
    reqs, step = [], 0
    while reqs == [] or any(not r.done for r in reqs) or srv.queue:
        for _ in range(schedule.get(step, 0)):
            n = int(rng.randint(3, 9))
            r = req_cls(prompt=rng.randint(0, 512, size=plen or n).tolist(),
                        max_new_tokens=int(rng.randint(2, 6)))
            srv.submit(r)
            reqs.append(r)
        srv.step()
        step += 1
        assert step < 200
    return [r.output for r in reqs]


@pytest.mark.parametrize("leg", LEGS)
def test_slot_server_matches_reference(weights, leg, monkeypatch):
    """The port's slot Server gives the reference Server's greedy streams
    on the float32 smoke deepseek-v3, and the same KV bytes (every latent
    leaf of both stacks). Under CIM the routed experts take one
    expert-batched B2 / B5 call per projection (their plain versions on
    CPU tensors, counted here; no launch is counted). The reference
    Server runs jitted, except at bp-noisy: there the jitted reference is
    not its own eager execution (request 2's prefill logits move by up to
    2.73 and its first token flips, 436 jitted vs 416 eager, at an eager
    top-2 margin of 0.036; ROADMAP Queue C), and the port is held to the
    eager one: the reference Server with its prefill and decode step run
    op by op (layers unrolled, no jit around them), every prompt 9 tokens
    long so that each op compiles once (the mixed lengths cost 90 s)."""
    ref_cfg, cfg = _cfgs(leg)
    kw = dict(n_slots=2, max_len=MAX_LEN)
    port = tserver.Server(
        registry.params_from_numpy(weights[1], cfg, device="cpu"), cfg,
        tserver.ServingConfig(**kw), device="cpu")
    plain = {"bp": "cim_mvm_grouped_experts_plain",
             "bp-noisy": "cim_mvm_grouped_noisy_experts_plain"}.get(leg)
    calls = []
    if plain is not None:
        fn = getattr(cim_mvm, plain)
        monkeypatch.setattr(cim_mvm, plain,
                            lambda *a, **k: calls.append(1) or fn(*a, **k))
    plen = 9 if leg == "bp-noisy" else None
    build.reset_launch_counts()
    out = _mixed_depth(port, tserver.Request, plen)
    assert build.launch_counts()["cim_mvm_grouped_experts"] == 0
    ref = rserver.Server(weights[0], ref_cfg,
                         rserver.ServingConfig(telemetry=False, **kw))
    if leg == "bp-noisy":
        eager = ref_cfg.replace(scan_layers=False)
        ref._decode = lambda p, t, c: ref_tf.decode_step(p, t, c, eager)
        ref._prefill = lambda p, b: ref_tf.prefill(p, b, eager,
                                                   max_len=MAX_LEN)
    assert out == _mixed_depth(ref, rserver.Request, plen)
    assert port.kv_cache_bytes() == ref.kv_cache_bytes()
    if plain is not None:
        # 3 projections x 2 MoE layers per forward
        assert len(calls) >= 3 * 2 * 5 and len(calls) % (3 * 2) == 0


def test_prequant_decode_raises_in_both(weights):
    """Stored codes replace the float w_uk / w_uv that the absorbed decode
    reads: the port's slot Server prefills, then its first decode step
    raises KeyError naming the cause; the reference's decode_step on the
    same quantized weights raises KeyError 'w_uk' (its Server raises it at
    the first decode step; ROADMAP Queue C)."""
    ref_cfg, cfg = _cfgs("bp")
    port = tserver.Server(
        registry.params_from_numpy(weights[1], cfg, device="cpu"), cfg,
        tserver.ServingConfig(n_slots=2, max_len=MAX_LEN, prequant=True),
        device="cpu")
    assert "w_uk_q" in port.params["layers"][0]["attn"]
    port.submit(tserver.Request(prompt=[1, 2, 3, 4], max_new_tokens=3))
    with pytest.raises(KeyError, match="quantize_params"):
        port.step()
    assert port.metrics.prefill_tokens == 4
    rq = jax.jit(lambda p: ref_quantize(p, ref_cfg))(weights[0])
    cache = ref_tf.init_cache(ref_cfg, 2, MAX_LEN)
    with pytest.raises(KeyError, match="w_uk"):
        ref_tf.decode_step(rq, jnp.zeros((2, 1), jnp.int32), cache, ref_cfg)


def test_paged_engine_raises_for_mla():
    """MLA's latent cache has no paged layout in either package."""
    ref_cfg, cfg = _cfgs("off")
    with pytest.raises(NotImplementedError):
        ref_tf.init_paged_cache(ref_cfg, 9, 8)
    with pytest.raises(NotImplementedError, match="MLA"):
        transformer.init_paged_cache(cfg, 9, 8, device="cpu")
    assert not transformer.supports_paged(cfg)
    with pytest.raises(NotImplementedError, match="paged"):
        tserver.Server(transformer.init(cfg, device="cpu"), cfg,
                       tserver.ServingConfig(paged=True, n_slots=2,
                                             max_len=MAX_LEN), device="cpu")
