"""zamba2-2.7b in the port (`models/mamba2.py`: the Mamba2 SSD blocks and
the weight-shared attention block) against the reference, on the
reference's own weights of the float32 smoke config (6 layers, d_model
128, d_inner 256 in 8 heads of 32, N 16, chunk 16, the shared block after
layers 3 and 6) carried across by `params_from_numpy`, inputs from numpy
seeds.

Exact (bit for bit): the causal depthwise conv before its SiLU and its
carried state; every `dense` call of a Mamba block and of the shared
block under --cim bp-prequant against the reference's `dense` on the same
input and the reference's stored codes; `quantize_params` on the whole
tree, the shared block included; the slot Server's greedy streams at
--cim off, bp-prequant and bp-noisy (noise_seed 0) on a mixed-length
schedule with mid-run admission, and its KV bytes.

Within a stated tolerance, relative to the largest |value| of the
reference's output: softplus, the conv after its SiLU, `_gated_norm`,
`ssd_chunked` (and the chunked form against the port's own exact
recurrence), the Mamba block at --cim off, TOL; `prefill` / `decode_step`
logits and caches, TOL_MODEL. torch's exp, log1p, sigmoid and rsqrt and
its f32 einsum sums differ from XLA:CPU's in the last bits (measured: the
functions up to 2.7e-7); the blocks run without a residual, as in the
reference, and the six of them grow that to 1e-5 in the model. The
reference runs op by op (no jit) where held to a tolerance; its Servers
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
from repro.models import mamba2 as ref_mamba2  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models.quantize import quantize_params as ref_quantize  # noqa
from repro.runtime import server as rserver  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.models import common, mamba2, registry  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.runtime import server as tserver  # noqa: E402

ARCH = "zamba2-2.7b"
MAX_LEN = 64
# the digital functions and one block, relative to the reference's
# largest |value|; measured up to 2.7e-7
TOL = 4e-6
# prefill / decode_step logits and caches; measured up to 1.0e-5
TOL_MODEL = 4e-5
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
def test_conv1d_exact_before_its_silu(monkeypatch):
    """The causal depthwise conv over a carried 3-row history: the sum
    before the SiLU bit for bit (both SiLUs made the identity), the new
    history exactly, and with the SiLUs within TOL."""
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 13, 40)).astype(np.float32)
    w = rng.standard_normal((4, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    st = rng.standard_normal((2, 3, 40)).astype(np.float32)

    def both():
        out = []
        for s in (None, st):
            r = ref_mamba2._conv1d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b),
                                   None if s is None else jnp.asarray(s))
            t = mamba2._conv1d(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b),
                               None if s is None else torch.from_numpy(s))
            out.append((np.asarray(r[0]), t[0].numpy(), np.asarray(r[1]),
                        t[1].numpy()))
        return out

    for r_out, t_out, r_st, t_st in both():
        assert rel_err(t_out, r_out) <= TOL
        assert np.array_equal(t_st, r_st)
    monkeypatch.setattr(jax.nn, "silu", lambda a: a)
    monkeypatch.setattr(mamba2, "silu", lambda a: a)
    for r_out, t_out, _, _ in both():
        assert np.array_equal(t_out, r_out)


def test_softplus_and_gated_norm_match_reference():
    rng = np.random.RandomState(2)
    x = (rng.standard_normal((2, 9, 64)) * 6).astype(np.float32)
    assert rel_err(mamba2.softplus(torch.from_numpy(x)).numpy(),
                    np.asarray(jax.nn.softplus(jnp.asarray(x)))) <= TOL
    z = rng.standard_normal((2, 9, 64)).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    y = mamba2._gated_norm(*map(torch.from_numpy, (x, z, g)))
    y_ref = ref_mamba2._gated_norm(*map(jnp.asarray, (x, z, g)))
    assert rel_err(y.numpy(), np.asarray(y_ref)) <= TOL


def _ssd_inputs(seed, b=2, t=37, h=4, dh=32, n=16):
    rng = np.random.RandomState(seed)
    xh = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, t, h))) * 0.1).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    B, C = (rng.standard_normal((b, t, n)).astype(np.float32)
            for _ in range(2))
    s0 = rng.standard_normal((b, h, dh, n)).astype(np.float32)
    return xh, dt, a, B, C, s0


def test_ssd_chunked_matches_reference():
    """A chunk-unaligned T (37 over chunks of 16) from a nonzero state."""
    xh, dt, a, B, C, s0 = _ssd_inputs(3)
    y_ref, s_ref = ref_mamba2.ssd_chunked(
        *map(jnp.asarray, (xh, dt, a, B, C)), chunk=16,
        state0=jnp.asarray(s0), unroll=True)
    y, s = mamba2.ssd_chunked(*map(torch.from_numpy, (xh, dt, a, B, C)),
                              chunk=16, state0=torch.from_numpy(s0))
    assert y.shape == (2, 37, 4, 32) and s.shape == (2, 4, 32, 16)
    assert rel_err(y.numpy(), np.asarray(y_ref)) <= TOL
    assert rel_err(s.numpy(), np.asarray(s_ref)) <= TOL


def test_ssd_chunked_equals_the_exact_recurrence():
    """The chunked form against the port's own token-by-token recurrence
    (decode's path): padding steps have dt = 0, so the final states agree
    too."""
    xh, dt, a, B, C, s0 = map(torch.from_numpy, _ssd_inputs(4))
    y, s = mamba2.ssd_chunked(xh, dt, a, B, C, chunk=16, state0=s0)
    state, ys = s0, []
    for i in range(xh.shape[1]):
        yi, state = mamba2.ssd_recurrent(xh[:, i], dt[:, i], a, B[:, i],
                                         C[:, i], state)
        ys.append(yi)
    assert rel_err(torch.stack(ys, 1).numpy(), y.numpy()) <= TOL
    assert rel_err(state.numpy(), s.numpy()) <= TOL


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunked", [True, False])
def test_mamba_block_matches_reference_at_cim_off(weights, chunked):
    """Layer 0's Mamba block over a prompt (chunked, from zero carries)
    and as one decode token (from a random conv history and state)."""
    ref_cfg, cfg = leg_cfgs(ARCH, "off")
    p = _port_params(weights, cfg)["layers"][0]["ssm"]
    rp = jax.tree.map(lambda a: a[0], weights[0]["layers"]["ssm"])
    rng = np.random.RandomState(5)
    t = 21 if chunked else 1
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    cache = None if chunked else {
        "conv": rng.standard_normal((2, 3, 288)).astype(np.float32),
        "S": rng.standard_normal((2, 8, 32, 16)).astype(np.float32)}
    y_ref, c_ref = ref_mamba2._mamba_block(
        rp, jnp.asarray(x), ref_cfg, train=False, chunked=chunked,
        cache=None if cache is None else jax.tree.map(jnp.asarray, cache))
    y, c = mamba2._mamba_block(
        p, torch.from_numpy(x), cfg, chunked=chunked,
        cache=None if cache is None else {k: torch.from_numpy(v)
                                          for k, v in cache.items()})
    assert rel_err(np32(y), np32(y_ref)) <= TOL
    assert rel_err(np32(c["S"]), np32(c_ref["S"])) <= TOL
    assert rel_err(np32(c["conv"]), np32(c_ref["conv"])) <= TOL
    if not chunked:      # the history's older rows move up unchanged
        assert np.array_equal(np32(c["conv"])[:, :2], cache["conv"][:, 1:])


def test_dense_calls_bit_exact_under_prequant(weights, monkeypatch):
    """Under --cim bp-prequant the Mamba block's w_in and w_out and the
    shared block's seven projections equal the reference's `dense` on the
    same input and the reference's stored codes, bit for bit."""
    ref_cfg, cfg = leg_cfgs(ARCH, "bp-prequant")
    q = quantize_params(_port_params(weights, cfg), cfg)
    rq = ref_quantize(weights[0], ref_cfg)
    rlp = jax.tree.map(lambda a: a[0], rq["layers"])
    calls = []
    inner = common.dense

    def recording(p, x, c, **kw):
        y = inner(p, x, c, **kw)
        calls.append((p, x, kw["w"], y))
        return y

    monkeypatch.setattr(mamba2, "dense", recording)
    monkeypatch.setattr(common, "dense", recording)
    rng = np.random.RandomState(6)
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    mamba2._mamba_block(q["layers"][0]["ssm"], torch.from_numpy(x), cfg)
    pos = torch.arange(19).expand(2, 19)
    mamba2._shared_block(q["shared"], torch.from_numpy(x), cfg,
                         positions=pos, cache={})
    assert [w for _, _, w, _ in calls] == ["w_in", "w_out", "wq", "wk",
                                           "wv", "wo", "w_up", "w_gate",
                                           "w_down"]
    for p, xin, w, y in calls:
        if w in ("w_in", "w_out"):
            rp = rlp["ssm"]
        else:
            rp = rq["shared"]["attn" if w in ("wq", "wk", "wv", "wo")
                              else "mlp"]
        y_ref = ref_common.dense(rp, jnp.asarray(np32(xin)), ref_cfg,
                                 train=False, w=w, b=None)
        assert np.array_equal(np32(y), np32(y_ref)), w


# ---------------------------------------------------------------------------
# params, quantization, prefill / decode_step
# ---------------------------------------------------------------------------
def test_params_from_numpy_and_quantize_match_reference(weights):
    """The stacked layers become per-layer {"norm1", "ssm"} dicts and the
    shared block is carried as one block; quantize_params stores w_in,
    w_out, the shared block's projections and the head (the conv, A, dt
    bias, D and the norms stay float) with the reference's codes."""
    ref_cfg, cfg = leg_cfgs(ARCH, "bp-prequant")
    p = _port_params(weights, cfg)
    assert len(p["layers"]) == cfg.n_layers
    assert set(p["layers"][0]) == {"norm1", "ssm"}
    assert set(p["shared"]) == {"norm1", "attn", "norm2", "mlp"}
    assert p["shared"]["attn"]["wq"].shape == (cfg.d_model, cfg.d_model)
    mine = mamba2.init(cfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in mine["layers"][0]["ssm"].items()} \
        == {k: tuple(v.shape) for k, v in p["layers"][0]["ssm"].items()}
    assert set(mine["shared"]) == set(p["shared"])
    rq = to_numpy_tree(ref_quantize(weights[0], ref_cfg))
    q = quantize_params(p, cfg)
    for i, lq in enumerate(q["layers"]):
        for n in ("w_in", "w_out"):
            for suffix in ("_q", "_scale"):
                assert np.array_equal(lq["ssm"][n + suffix].numpy(),
                                      rq["layers"]["ssm"][n + suffix][i])
        assert lq["ssm"]["conv_w"].dtype == torch.float32
    for blk, names in (("attn", ("wq", "wk", "wv", "wo")),
                       ("mlp", ("w_gate", "w_up", "w_down"))):
        for n in names:
            assert n not in q["shared"][blk]
            assert np.array_equal(q["shared"][blk][n + "_q"].numpy(),
                                  rq["shared"][blk][n + "_q"])
    assert np.array_equal(q["tok"]["head_q"].numpy(), rq["tok"]["head_q"])


def test_prefill_decode_match_reference(weights):
    """A 21-token prompt prefilled alone (the shared block's K/V of both
    applications padded to max_len) and spliced into slot 1 of a 2-slot
    cache, then two decode steps at the shared position: logits, the conv
    histories, the SSD states and the shared K/V, at --cim off (the CIM
    legs are held bit for bit by the Server's streams below)."""
    ref_cfg, cfg = leg_cfgs(ARCH, "off")
    rp, tp = weights[0], _port_params(weights, cfg)
    rng = np.random.RandomState(8)
    toks = rng.randint(0, cfg.vocab, (1, 21)).astype(np.int32)
    rl, rreq = ref_mamba2.prefill(rp, {"tokens": jnp.asarray(toks)},
                                  ref_cfg, max_len=MAX_LEN)
    tl, treq = mamba2.prefill(tp, {"tokens": torch.from_numpy(toks)}, cfg,
                              max_len=MAX_LEN)
    assert tl.shape == (1, cfg.vocab) and int(treq["pos"]) == 21
    assert treq["shared"]["k"].shape == (2, 1, MAX_LEN, 4, 32)
    assert rel_err(np32(tl), np32(rl)) <= TOL_MODEL
    rc = rserver._splice(ref_mamba2.init_cache(ref_cfg, 2, MAX_LEN), rreq, 1)
    tc = tserver._splice(mamba2.init_cache(cfg, 2, MAX_LEN, device="cpu"),
                         treq, 1)

    def same(tcache, rcache):
        for stack, leaf in (("layers", "conv"), ("layers", "S"),
                            ("shared", "k"), ("shared", "v")):
            assert tcache[stack][leaf].shape == rcache[stack][leaf].shape
            assert rel_err(np32(tcache[stack][leaf]),
                            np32(rcache[stack][leaf])) <= TOL_MODEL, leaf

    same(tc, rc)
    for _ in range(2):
        nxt = rng.randint(0, cfg.vocab, (2, 1)).astype(np.int32)
        rl, rc = ref_mamba2.decode_step(rp, jnp.asarray(nxt), rc, ref_cfg)
        tl, tc = mamba2.decode_step(tp, torch.from_numpy(nxt), tc, cfg)
        assert int(tc["pos"]) == int(rc["pos"])
        assert rel_err(np32(tl), np32(rl)) <= TOL_MODEL
        same(tc, rc)


# bf16 at --cim off: the port's mean RMS distance from the float32 witness
# over four prompts, as a share of the reference's; measured 0.86
BF16_RATIO = 1.25


def test_bf16_no_farther_from_float32_than_the_reference(weights):
    """In bf16 the port's and the reference's prefill logits differ by
    up to 0.4 at a largest |logit| of 3.8: six blocks without a residual
    grow each package's bf16 rounding. A third witness, the reference in
    float32 on the same bf16 weights, tells rounding from a fault (a cast
    or an op order that differs): the port must lie no farther from it
    than BF16_RATIO times the reference's own bf16 run, in the mean over
    four 21-token prompts of the RMS distance. The top-1 tokens are
    printed, not held: where the witness's top-2 margin is small, bf16
    rounding in either package flips them."""
    ref_cfg, cfg = leg_cfgs(ARCH, "off")
    rcb, tcb = ref_cfg.replace(dtype="bfloat16"), cfg.replace(dtype="bfloat16")
    # the bf16 init is the float32 init rounded: cast each leaf to the
    # dtype the bf16 init gives it
    dtypes = jax.eval_shape(
        lambda: ref_registry.init_params(jax.random.PRNGKey(0), rcb))
    rpb = jax.tree_util.tree_map(lambda a, s: a.astype(s.dtype), weights[0],
                                 dtypes)
    rp32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        rpb)
    tpb = registry.params_from_numpy(to_numpy_tree(rpb), tcb, device="cpu")
    toks = np.random.RandomState(100).randint(0, cfg.vocab, (4, 21)) \
        .astype(np.int32)
    witness, ref, port = (np32(lg) for lg in (
        ref_mamba2.prefill(rp32, {"tokens": jnp.asarray(toks)}, ref_cfg,
                           max_len=MAX_LEN)[0],
        ref_mamba2.prefill(rpb, {"tokens": jnp.asarray(toks)}, rcb,
                           max_len=MAX_LEN)[0],
        mamba2.prefill(tpb, {"tokens": torch.from_numpy(toks)}, tcb,
                       max_len=MAX_LEN)[0]))
    top1 = np.argmax(witness, -1)
    agree = [int((np.argmax(x, -1) == top1).sum()) for x in (ref, port)]
    top2 = np.sort(witness, -1)[:, -2:]
    ref_d, port_d = (float(np.mean(np.sqrt(np.mean((x - witness) ** 2, -1))))
                     for x in (ref, port))
    print(f"bf16 mean RMS distance from the float32 witness: reference "
          f"{ref_d:.4f}, port {port_d:.4f} ({port_d / ref_d:.2f}x); "
          f"port vs reference max {np.max(np.abs(port - ref)):.4f}, "
          f"largest |logit| {np.max(np.abs(witness)):.4f}; top-1 as the "
          f"witness's: reference {agree[0]}/4, port {agree[1]}/4 (the "
          f"witness's top-2 margins {np.round(top2[:, 1] - top2[:, 0], 4)})")
    assert port_d <= BF16_RATIO * ref_d


# ---------------------------------------------------------------------------
# the slot Server
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("leg", LEGS)
def test_slot_server_matches_reference(weights, leg):
    """The port's slot Server gives the jitted reference Server's greedy
    streams and KV bytes (conv histories, states and the shared K/V)."""
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
        tserver.Server(mamba2.init(cfg, device="cpu"), cfg,
                       tserver.ServingConfig(paged=True, max_len=MAX_LEN),
                       device="cpu")
    assert str(port_err.value) == str(ref_err.value) == msg
    assert not mamba2.supports_paged(cfg)
