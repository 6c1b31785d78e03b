"""rwkv6-7b in the port (`models/rwkv6.py`) against the reference, on the
reference's own weights of the float32 smoke config (2 layers, d_model
128, 4 heads of 32, chunk 16) carried across by `params_from_numpy`,
inputs from numpy seeds.

Exact (bit for bit): the token shift; the cumulative sum in XLA:CPU's
order (`cumsum_f32` against jnp.cumsum); every `dense` call of a layer
under --cim bp-prequant against the reference's `dense` on the same
input and the reference's stored codes; `quantize_params` on the whole
tree; the slot Server's greedy streams at --cim off, bp-prequant and
bp-noisy (noise_seed 0) on a mixed-length schedule with mid-run
admission, and its KV bytes.

Within a stated tolerance, relative to the largest |value| of the
reference's output: `_decay`, `_group_norm`, `wkv6_chunked` (and the
chunked form against the port's own exact recurrence), the time-mix and
channel-mix blocks at --cim off, and `prefill` / `decode_step` logits and
caches, TOL. torch's exp, tanh and rsqrt and its f32 einsum sums differ
from XLA:CPU's in the last bits (measured: the functions up to 1.5e-7,
the model up to 1.1e-6). The reference runs op by op (no jit) where held
to a tolerance, because jit fuses x + μ·(xs − x) into an FMA; its Servers
run jitted, as in production.
"""
import numpy as np
import pytest
import torch

from _torch_helpers import (leg_cfgs, mixed_depth, np32, rel_err,
                            to_numpy_tree)
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import SMOKES as REF_SMOKES  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models import rwkv6 as ref_rwkv6  # noqa: E402
from repro.models.quantize import quantize_params as ref_quantize  # noqa
from repro.runtime import server as rserver  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.models import registry, rwkv6  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.runtime import server as tserver  # noqa: E402

ARCH = "rwkv6-7b"
MAX_LEN = 64
# the digital functions, the blocks and the model, relative to the
# reference's largest |value|; measured up to 1.5e-7 (functions) and
# 1.1e-6 (prefill / decode_step logits and caches)
TOL = 4e-6
LEGS = ("off", "bp-prequant", "bp-noisy")


@pytest.fixture(scope="module")
def weights():
    cfg = REF_SMOKES[ARCH].replace(dtype="float32")
    params = ref_registry.init_params(jax.random.PRNGKey(0), cfg)
    return params, to_numpy_tree(params)


def _port_params(weights, cfg):
    return registry.params_from_numpy(weights[1], cfg, device="cpu")


# ---------------------------------------------------------------------------
# the digital state math
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [7, 16, 32, 64, 300])
def test_cumsum_f32_bit_exact_vs_jnp_cumsum(n):
    """XLA:CPU's block order of the cumulative sum (blocks of 16), along
    an inner axis; torch.cumsum (double accumulation) rounds otherwise."""
    rng = np.random.RandomState(n)
    x = (rng.standard_normal((3, n, 5))
         * np.exp(rng.standard_normal((3, n, 5)))).astype(np.float32)
    ref = np.asarray(jnp.cumsum(jnp.asarray(x), axis=1))
    assert np.array_equal(rwkv6.cumsum_f32(torch.from_numpy(x), 1).numpy(),
                          ref)


def test_token_shift_exact():
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    prev = rng.standard_normal((2, 1, 16)).astype(np.float32)
    for p in (None, prev):
        ref = ref_rwkv6._token_shift(jnp.asarray(x), None if p is None
                                     else jnp.asarray(p))
        out = rwkv6._token_shift(torch.from_numpy(x), None if p is None
                                 else torch.from_numpy(p))
        assert np.array_equal(out.numpy(), np.asarray(ref))


def test_decay_and_group_norm_match_reference(weights):
    """The decay LoRA (float f32 matmuls off the macro, clamped log-decay)
    and the per-head group norm, on layer 0's weights."""
    _, cfg = leg_cfgs(ARCH, "off")
    tm = _port_params(weights, cfg)["layers"][0]["tm"]
    rtm = jax.tree.map(lambda a: a[0], weights[0]["layers"]["tm"])
    x = np.random.RandomState(2).standard_normal((2, 11, cfg.d_model)) \
        .astype(np.float32) * 3
    lw = rwkv6._decay(tm, torch.from_numpy(x)).numpy()
    lw_ref = np.asarray(ref_rwkv6._decay(rtm, jnp.asarray(x)))
    assert lw.dtype == np.float32 and lw.max() <= -1e-4 \
        and lw.min() >= rwkv6.LOG_DECAY_FLOOR
    assert rel_err(lw, lw_ref) <= TOL
    g = np.random.RandomState(3).standard_normal(cfg.d_model) \
        .astype(np.float32)
    y = rwkv6._group_norm(torch.from_numpy(x), torch.from_numpy(g), 4)
    y_ref = ref_rwkv6._group_norm(jnp.asarray(x), jnp.asarray(g), 4)
    assert rel_err(y.numpy(), np.asarray(y_ref)) <= TOL


def _wkv_inputs(seed, b=2, t=37, h=4, dh=32):
    rng = np.random.RandomState(seed)
    r, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32)
               for _ in range(3))
    lw = np.clip(-np.exp(rng.uniform(-8, 1, (b, t, h, dh))), -5.0, -1e-4) \
        .astype(np.float32)
    u = rng.standard_normal((h, dh)).astype(np.float32)
    s0 = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    return r, k, v, lw, u, s0


def test_wkv6_chunked_matches_reference():
    """A chunk-unaligned T (37 over chunks of 16, log-decays padded with
    −1e-4) from a nonzero state."""
    r, k, v, lw, u, s0 = _wkv_inputs(4)
    y_ref, s_ref = ref_rwkv6.wkv6_chunked(
        *map(jnp.asarray, (r, k, v, lw, u)), chunk=16,
        state0=jnp.asarray(s0), unroll=True)
    y, s = rwkv6.wkv6_chunked(*map(torch.from_numpy, (r, k, v, lw, u)),
                              chunk=16, state0=torch.from_numpy(s0))
    assert y.shape == (2, 37, 4, 32) and s.shape == (2, 4, 32, 32)
    assert rel_err(y.numpy(), np.asarray(y_ref)) <= TOL
    assert rel_err(s.numpy(), np.asarray(s_ref)) <= TOL


def test_wkv6_chunked_equals_the_exact_recurrence():
    """The chunked form against the port's own token-by-token recurrence
    (decode's path) over the same 37 tokens and state. The chunked final
    state has also run through the 11 padding steps (k = v = 0, log-decay
    −1e-4), as the reference's does: a further decay of exp(−1.1e-3),
    which the recurrence shows when it runs those steps too."""
    r, k, v, lw, u, s0 = map(torch.from_numpy, _wkv_inputs(5))
    y, s = rwkv6.wkv6_chunked(r, k, v, lw, u, chunk=16, state0=s0)
    state, ys = s0, []
    for i in range(r.shape[1]):
        yi, state = rwkv6.wkv6_recurrent(r[:, i], k[:, i], v[:, i],
                                         lw[:, i], u, state)
        ys.append(yi)
    assert rel_err(torch.stack(ys, 1).numpy(), y.numpy()) <= TOL
    assert rel_err(state.numpy(), s.numpy()) > 1e-3
    zero = torch.zeros_like(r[:, 0])
    for _ in range(11):
        _, state = rwkv6.wkv6_recurrent(zero, zero, zero,
                                        torch.full_like(zero, -1e-4), u,
                                        state)
    assert rel_err(state.numpy(), s.numpy()) <= TOL


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunked", [True, False])
def test_blocks_match_reference_at_cim_off(weights, chunked):
    """Layer 0's time mix and channel mix, over a prompt (chunked, from the
    zero carries) and as one decode token (from random carries and
    state)."""
    ref_cfg, cfg = leg_cfgs(ARCH, "off")
    lp = _port_params(weights, cfg)["layers"][0]
    rlp = jax.tree.map(lambda a: a[0], weights[0]["layers"])
    rng = np.random.RandomState(6)
    t = 21 if chunked else 1
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    prev = None if chunked else \
        rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    s0 = None if chunked else \
        rng.standard_normal((2, 4, 32, 32)).astype(np.float32)
    j = (lambda a: None if a is None else jnp.asarray(a))
    tt = (lambda a: None if a is None else torch.from_numpy(a))
    out_ref, (lx_ref, s_ref) = ref_rwkv6._time_mix(
        rlp["tm"], jnp.asarray(x), ref_cfg, train=False, prev_x=j(prev),
        state=j(s0), chunked=chunked)
    out, (lx, s) = rwkv6._time_mix(lp["tm"], torch.from_numpy(x), cfg,
                                   prev_x=tt(prev), state=tt(s0),
                                   chunked=chunked)
    assert rel_err(np32(out), np32(out_ref)) <= TOL
    assert rel_err(np32(s), np32(s_ref)) <= TOL
    assert np.array_equal(np32(lx), np32(lx_ref))
    f_ref, c_ref = ref_rwkv6._channel_mix(rlp["cm"], jnp.asarray(x), ref_cfg,
                                          train=False, prev_x=j(prev),
                                          chunked=chunked)
    f, c = rwkv6._channel_mix(lp["cm"], torch.from_numpy(x), cfg,
                              prev_x=tt(prev), chunked=chunked)
    assert rel_err(np32(f), np32(f_ref)) <= TOL
    assert np.array_equal(np32(c), np32(c_ref))


def test_layer_dense_calls_bit_exact_under_prequant(weights, monkeypatch):
    """Under --cim bp-prequant every projection of a layer (w_r, w_k,
    w_v, w_g, w_out; the channel mix's w_up, w_down, w_r) equals the
    reference's `dense` on the same input and the reference's stored
    codes, bit for bit."""
    ref_cfg, cfg = leg_cfgs(ARCH, "bp-prequant")
    lp = quantize_params(_port_params(weights, cfg), cfg)["layers"][0]
    rlp = jax.tree.map(lambda a: a[0], ref_quantize(weights[0],
                                                    ref_cfg)["layers"])
    calls = []
    inner = rwkv6.dense

    def recording(p, x, c, **kw):
        y = inner(p, x, c, **kw)
        calls.append((p, x, kw["w"], y))
        return y

    monkeypatch.setattr(rwkv6, "dense", recording)
    x = np.random.RandomState(7).standard_normal((2, 19, cfg.d_model)) \
        .astype(np.float32)
    rwkv6._layer(lp, torch.from_numpy(x), cfg, chunked=True)
    assert [w for _, _, w, _ in calls] == ["w_r", "w_k", "w_v", "w_g",
                                           "w_out", "w_up", "w_down", "w_r"]
    for p, xin, w, y in calls:
        block = "tm" if p is lp["tm"] else "cm"
        y_ref = ref_common.dense(rlp[block], jnp.asarray(np32(xin)), ref_cfg,
                                 train=False, w=w, b=None)
        assert np.array_equal(np32(y), np32(y_ref)), (block, w)


# ---------------------------------------------------------------------------
# params, quantization, prefill / decode_step
# ---------------------------------------------------------------------------
def test_params_from_numpy_and_quantize_match_reference(weights):
    """The stacked layers become per-layer {"norm1", "tm", "norm2", "cm"}
    dicts; quantize_params stores the eight projections and the head (the
    decay LoRA, μ and the norms stay float) with the reference's codes."""
    _, cfg = leg_cfgs(ARCH, "bp-prequant")
    p = _port_params(weights, cfg)
    assert len(p["layers"]) == cfg.n_layers
    assert set(p["layers"][1]) == {"norm1", "tm", "norm2", "cm"}
    assert np.array_equal(p["layers"][1]["tm"]["decay_a"].numpy(),
                          np.asarray(weights[0]["layers"]["tm"]["decay_a"][1]))
    mine = rwkv6.init(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda a: a.shape, to_numpy_tree(
        jax.tree.map(lambda a: a[0], weights[0]["layers"]))) == \
        {k: {n: tuple(t.shape) for n, t in v.items()}
         if isinstance(v, dict) else tuple(v.shape)
         for k, v in mine["layers"][0].items()}
    ref_cfg, _ = leg_cfgs(ARCH, "bp-prequant")
    rq = to_numpy_tree(ref_quantize(weights[0], ref_cfg))
    q = quantize_params(p, cfg)
    for i, lq in enumerate(q["layers"]):
        for block, names in (("tm", ("w_r", "w_k", "w_v", "w_g", "w_out")),
                             ("cm", ("w_up", "w_down", "w_r"))):
            assert "decay_a" not in lq[block] or block == "tm"
            for n in names:
                assert n not in lq[block]
                for suffix in ("_q", "_scale"):
                    assert np.array_equal(
                        lq[block][n + suffix].numpy(),
                        rq["layers"][block][n + suffix][i]), (i, block, n)
        assert lq["tm"]["decay_a"].dtype == torch.float32
    assert np.array_equal(q["tok"]["head_q"].numpy(), rq["tok"]["head_q"])


@pytest.mark.parametrize("leg", ["off", "bp-prequant"])
def test_prefill_decode_match_reference(weights, leg):
    """A 21-token prompt (one chunk and a part) prefilled alone and
    spliced into slot 1 of a 2-slot cache (slot 0 idle, its state evolving
    on token 0), then two decode steps: logits and every cache leaf."""
    ref_cfg, cfg = leg_cfgs(ARCH, leg)
    rp, tp = weights[0], _port_params(weights, cfg)
    if leg == "bp-prequant":
        rp = ref_quantize(rp, ref_cfg)
        tp = quantize_params(tp, cfg)
    rng = np.random.RandomState(8)
    toks = rng.randint(0, cfg.vocab, (1, 21)).astype(np.int32)
    rl, rreq = ref_rwkv6.prefill(rp, {"tokens": jnp.asarray(toks)}, ref_cfg,
                                 max_len=MAX_LEN)
    tl, treq = rwkv6.prefill(tp, {"tokens": torch.from_numpy(toks)}, cfg,
                             max_len=MAX_LEN)
    assert tl.shape == (1, cfg.vocab) and int(treq["pos"]) == 21
    assert rel_err(np32(tl), np32(rl)) <= TOL
    rc = rserver._splice(ref_rwkv6.init_cache(ref_cfg, 2, MAX_LEN), rreq, 1)
    tc = tserver._splice(rwkv6.init_cache(cfg, 2, MAX_LEN, device="cpu"),
                         treq, 1)
    for leaf in ("tm_x", "cm_x", "S"):
        assert tc["layers"][leaf].shape == rc["layers"][leaf].shape
        assert rel_err(np32(tc["layers"][leaf]),
                        np32(rc["layers"][leaf])) <= TOL
    for _ in range(2):
        nxt = rng.randint(0, cfg.vocab, (2, 1)).astype(np.int32)
        rl, rc = ref_rwkv6.decode_step(rp, jnp.asarray(nxt), rc, ref_cfg)
        tl, tc = rwkv6.decode_step(tp, torch.from_numpy(nxt), tc, cfg)
        assert int(tc["pos"]) == int(rc["pos"])
        assert rel_err(np32(tl), np32(rl)) <= TOL
        for leaf in ("tm_x", "cm_x", "S"):
            assert rel_err(np32(tc["layers"][leaf]),
                            np32(rc["layers"][leaf])) <= TOL


# ---------------------------------------------------------------------------
# the slot Server
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("leg", LEGS)
def test_slot_server_matches_reference(weights, leg):
    """The port's slot Server gives the jitted reference Server's greedy
    streams and KV bytes (the carries and states of every slot)."""
    ref_cfg, cfg = leg_cfgs(ARCH, "bp" if leg == "bp-prequant" else leg)
    kw = dict(n_slots=2, max_len=MAX_LEN, prequant=leg == "bp-prequant")
    port = tserver.Server(_port_params(weights, cfg), cfg,
                          tserver.ServingConfig(**kw), device="cpu")
    out = mixed_depth(port, tserver.Request)
    ref = rserver.Server(weights[0], ref_cfg.replace(scan_layers=True),
                         rserver.ServingConfig(telemetry=False, **kw))
    assert out == mixed_depth(ref, rserver.Request)
    assert port.kv_cache_bytes() == ref.kv_cache_bytes()
    assert all(len(o) >= 2 for o in out)


def test_paged_engine_raises_as_the_reference():
    """No paged layout for the recurrent state in either package: the
    Server raises the reference's NotImplementedError."""
    ref_cfg, cfg = leg_cfgs(ARCH, "off")
    msg = f"paged serving not supported for arch '{ARCH}'"
    with pytest.raises(NotImplementedError) as ref_err:
        rserver.Server(ref_registry.init_params(jax.random.PRNGKey(0),
                                                ref_cfg), ref_cfg,
                       rserver.ServingConfig(paged=True, max_len=MAX_LEN))
    with pytest.raises(NotImplementedError) as port_err:
        tserver.Server(rwkv6.init(cfg, device="cpu"), cfg,
                       tserver.ServingConfig(paged=True, max_len=MAX_LEN),
                       device="cpu")
    assert str(port_err.value) == str(ref_err.value) == msg
    assert not rwkv6.supports_paged(cfg)
