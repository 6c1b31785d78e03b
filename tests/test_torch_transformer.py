"""`paged_step` of the port against the reference, on the reference's own
weights carried across by `params_from_numpy`.

A step sequence runs from an empty pool: a prefill chunk (C = 8, mixed
lanes, one idle), a decode step (C = 1), an all-positions step
(C = 3, `all_logits`) and a speculative verify step at spec_k 3 (C = 4,
`all_logits`, lanes clamped to 2 drafts), each compared on logits and on
the pools (blocks
>= 1; the trash block takes masked writes by design). Legs: --cim off,
bp and bp-prequant, and the seeded NOISY converter chain (noise_seed 0)
on the fly (bp-noisy, B5) and prequant (noisy-prequant, B6), in a float32
model and in the bfloat16 model.

Tolerances, relative to the largest |logit| of the step (pools: to their
largest |value|):
  * f32: 1e-5. The two frameworks differ in the last bits of rsqrt, exp,
    sin/cos and float matmul sums (measured: about 1e-6 without CIM; the
    CIM legs come out bit-identical, since a last-bit difference moves a
    DAC code only when the activation sits on a rounding boundary).
  * bf16: 2e-2, five bf16 ulps (2^-8 each) of accumulated rounding
    difference (measured: 9e-3): XLA computes bf16 SiLU/sigmoid in its
    own internal precision, torch rounds once from f32, so about a third
    of the SiLU outputs differ by one bf16 ulp.
The bf16 model under CIM is compared on layer 0's K/V pool only (written
before any bf16 nonlinearity) plus finite logits: there the one-ulp SiLU
differences flip DAC codes of the down projection, and one flipped code
moves its output by a whole ADC step (about 90 MAC units times the
scales, the size of the output itself at smoke width), so the reference
differs from itself by as much under a one-ulp perturbation of its input.
`test_dense_bf16_cim_bit_exact` holds the bf16 CIM layer itself exact.

The other dense archs (stablelm-3b: LayerNorm with bias, qkv bias, rotary
on a quarter of the head dim; llama3-8b; granite-3-8b: tied embeddings,
its head quantized on the fly from embed.T) run the same step sequence
and the slot engine's prefill + decode_step in the float32 model under
packed prequant with the kernel attention, at TOL["float32"].
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
from repro.models import registry as ref_registry  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.quantize import quantize_params as ref_quantize  # noqa
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.core.cim_matmul import CIMConfig  # noqa: E402
from repro_torch.core.macro import SimLevel  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, BS, MB = 4, 8, 4


def _noisy(cim_cls, level_cls):
    cim = cim_cls(enabled=True, noise_seed=0)
    return dataclasses.replace(cim, macro=dataclasses.replace(
        cim.macro, sim_level=level_cls.NOISY))


def _cfgs(dtype, cim, attn):
    ref = REF_SMOKES["internlm2-1.8b"].replace(dtype=dtype, attn_backend=attn)
    port = SMOKES["internlm2-1.8b"].replace(dtype=dtype, attn_backend=attn)
    if cim in ("bp-noisy", "noisy-prequant"):
        ref = ref.replace(cim=_noisy(RefCIM, RefLevel))
        port = port.replace(cim=_noisy(CIMConfig, SimLevel))
    elif cim != "off":
        ref = ref.replace(cim=RefCIM(enabled=True))
        port = port.replace(cim=CIMConfig(enabled=True))
    return ref, port


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def weights(request):
    cfg = REF_SMOKES["internlm2-1.8b"].replace(dtype=request.param)
    params = ref_registry.init_params(jax.random.PRNGKey(0), cfg)
    return request.param, params, to_numpy_tree(params)


def _schedule(rng, vocab):
    tables = np.zeros((B, MB), np.int32)
    tables[1] = [1, 2, 3, 0]
    tables[2] = [4, 5, 0, 0]
    tables[3] = [6, 7, 8, 9]
    steps = []
    lens = np.array([0, 0, 0, 0], np.int32)
    for c, valid in ((8, [0, 8, 5, 8]), (1, [0, 1, 1, 1]), (3, [0, 3, 2, 3]),
                     (4, [0, 4, 2, 4])):
        valid = np.array(valid, np.int32)
        toks = rng.randint(0, vocab, (B, c)).astype(np.int32)
        steps.append((toks, lens.copy(), valid, c in (3, 4)))
        lens = lens + valid
    return tables, steps


def _rel_err(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


@pytest.mark.parametrize("cim,attn", [("off", "exact"), ("off", "kernel"),
                                      ("bp", "exact"),
                                      ("bp-prequant", "exact"),
                                      ("bp-prequant", "kernel"),
                                      ("bp-noisy", "exact"),
                                      ("noisy-prequant", "kernel")])
def test_paged_step_matches_reference(weights, cim, attn):
    dtype, ref_params, tree = weights
    whole = dtype == "float32" or cim == "off"
    ref_cfg, cfg = _cfgs(dtype, cim, attn)
    params = registry.params_from_numpy(tree, cfg, device="cpu")
    if cim in ("bp-prequant", "noisy-prequant"):
        ref_params = ref_quantize(ref_params, ref_cfg)
        params = quantize_params(params, cfg)
    tables, steps = _schedule(np.random.RandomState(0), cfg.vocab)
    ref_cache = ref_tf.init_paged_cache(ref_cfg, B * MB + 1, BS)
    cache = transformer.init_paged_cache(cfg, B * MB + 1, BS, device="cpu")
    # the reference runs op by op (layers unrolled, no jit): XLA fusion
    # would rewrite w / s into w · (1/s), which moves bf16 weights that sit
    # on a rounding tie to the other weight code
    ref_cfg = ref_cfg.replace(scan_layers=False)
    tol = TOL[dtype]
    for toks, lens, valid, all_logits in steps:
        rl, ref_cache = ref_tf.paged_step(
            ref_params, jnp.asarray(toks), ref_cache, jnp.asarray(tables),
            jnp.asarray(lens), jnp.asarray(valid), ref_cfg,
            all_logits=all_logits)
        tl, cache = transformer.paged_step(
            params, torch.from_numpy(toks), cache, torch.from_numpy(tables),
            torch.from_numpy(lens), torch.from_numpy(valid), cfg,
            all_logits=all_logits)
        assert tl.shape == rl.shape and tl.dtype == torch.float32
        assert torch.isfinite(tl).all()
        live = valid > 0
        if whole:
            assert _rel_err(np32(tl)[live], np32(rl)[live]) <= tol
        layers = slice(None) if whole else slice(0, 1)
        for kv in ("k", "v"):
            assert _rel_err(np32(cache["layers"][kv])[layers, 1:],
                            np32(ref_cache["layers"][kv])[layers, 1:]) <= tol
        if not whole:
            break     # later steps read layer-0 pools written from layer 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prequant", [True, False])
def test_dense_bf16_cim_bit_exact(dtype, prequant):
    from repro.models import common as ref_common
    from repro_torch.models import common
    ref_cfg, cfg = _cfgs(dtype, "bp", "exact")
    rng = np.random.RandomState(3)
    x = rng.standard_normal((4, 3, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 96)) * 0.1).astype(np.float32)
    rp = {"wq": jnp.asarray(w).astype(ref_cfg.dtype)}
    tp = {"wq": torch.from_numpy(w).to(getattr(torch, dtype))}
    if prequant:
        rp, tp = ref_quantize(rp, ref_cfg), quantize_params(tp, cfg)
    yr = ref_common.dense(rp, jnp.asarray(x).astype(ref_cfg.dtype), ref_cfg,
                          w="wq", b=None)
    yt = common.dense(tp, torch.from_numpy(x).to(getattr(torch, dtype)), cfg,
                      w="wq", b=None)
    assert np.array_equal(np32(yr), np32(yt))


def test_params_from_numpy_layout(weights):
    dtype, _, tree = weights
    cfg = SMOKES["internlm2-1.8b"].replace(dtype=dtype)
    p = registry.params_from_numpy(tree, cfg, device="cpu")
    assert len(p["layers"]) == cfg.n_layers
    wq = p["layers"][1]["attn"]["wq"]
    assert wq.dtype == getattr(torch, dtype)
    assert np.array_equal(np32(wq), np.asarray(
        tree["layers"]["attn"]["wq"][1]).view(
            np.uint16 if dtype == "bfloat16" else np.float32).astype(
            np.uint32).__lshift__(16).view(np.float32)
        if dtype == "bfloat16" else tree["layers"]["attn"]["wq"][1])


def test_checkpoint_reader_round_trip(tmp_path):
    from repro.checkpoint.ckpt import save_pytree
    from repro_torch.checkpoint.ckpt import load_numpy_tree
    cfg = REF_SMOKES["internlm2-1.8b"]
    params = ref_registry.init_params(jax.random.PRNGKey(1), cfg)
    save_pytree(str(tmp_path / "ck"), params, metadata={"step": 3})
    tree, meta = load_numpy_tree(str(tmp_path / "ck"))
    assert meta == {"step": 3}
    want = to_numpy_tree(params)
    got = registry.params_from_numpy(tree, SMOKES["internlm2-1.8b"],
                                     device="cpu")
    ref = registry.params_from_numpy(want, SMOKES["internlm2-1.8b"],
                                     device="cpu")
    assert torch.equal(got["tok"]["head"], ref["tok"]["head"])
    assert torch.equal(got["layers"][0]["ffn"]["w_down"],
                       ref["layers"][0]["ffn"]["w_down"])


@pytest.mark.parametrize("packed", [True, False])
def test_quantize_params_matches_reference(weights, packed):
    dtype, ref_params, tree = weights
    ref_cfg, cfg = _cfgs(dtype, "bp", "exact")
    rq = ref_quantize(ref_params, ref_cfg, packed=packed)
    tq = quantize_params(registry.params_from_numpy(tree, cfg, device="cpu"),
                         cfg, packed=packed)
    for name in ("wq", "w_down"):
        grp = "attn" if name == "wq" else "ffn"
        for i in range(cfg.n_layers):
            assert np.array_equal(np.asarray(rq["layers"][grp][name + "_q"][i]),
                                  tq["layers"][i][grp][name + "_q"].numpy())
            assert np.array_equal(
                np.asarray(rq["layers"][grp][name + "_scale"][i]),
                tq["layers"][i][grp][name + "_scale"].numpy())
    assert np.array_equal(np.asarray(rq["tok"]["head_q"]),
                          tq["tok"]["head_q"].numpy())


def test_cow_copy_block_in_place():
    cfg = SMOKES["internlm2-1.8b"]
    cache = transformer.init_paged_cache(cfg, 5, 4, device="cpu")
    k = cache["layers"]["k"]
    k[:, 2] = 1.5
    out = transformer.cow_copy_block(cache, 2, 4)
    assert out is cache and torch.equal(k[:, 4], k[:, 2])


@pytest.mark.parametrize("arch", ["stablelm-3b", "llama3-8b",
                                  "granite-3-8b"])
def test_other_dense_archs_match_reference(arch):
    ref_cfg = REF_SMOKES[arch].replace(dtype="float32", attn_backend="kernel",
                                       cim=RefCIM(enabled=True))
    cfg = SMOKES[arch].replace(dtype="float32", attn_backend="kernel",
                               cim=CIMConfig(enabled=True))
    ref_params = ref_registry.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = quantize_params(registry.params_from_numpy(
        to_numpy_tree(ref_params), cfg, device="cpu"), cfg)
    ref_params = ref_quantize(ref_params, ref_cfg)
    if arch == "granite-3-8b":
        assert "head_q" not in params["tok"]           # tied: on the fly
    if arch == "stablelm-3b":
        assert "bias" in params["layers"][0]["norm1"]
        assert "bq" in params["layers"][0]["attn"]
    ref_cfg = ref_cfg.replace(scan_layers=False)
    tol = TOL["float32"]
    tables, steps = _schedule(np.random.RandomState(1), cfg.vocab)
    ref_cache = ref_tf.init_paged_cache(ref_cfg, B * MB + 1, BS)
    cache = transformer.init_paged_cache(cfg, B * MB + 1, BS, device="cpu")
    for toks, lens, valid, all_logits in steps[:2]:
        rl, ref_cache = ref_tf.paged_step(
            ref_params, jnp.asarray(toks), ref_cache, jnp.asarray(tables),
            jnp.asarray(lens), jnp.asarray(valid), ref_cfg,
            all_logits=all_logits)
        tl, cache = transformer.paged_step(
            params, torch.from_numpy(toks), cache, torch.from_numpy(tables),
            torch.from_numpy(lens), torch.from_numpy(valid), cfg,
            all_logits=all_logits)
        live = valid > 0
        assert _rel_err(np32(tl)[live], np32(rl)[live]) <= tol
        for kv in ("k", "v"):
            assert _rel_err(np32(cache["layers"][kv])[:, 1:],
                            np32(ref_cache["layers"][kv])[:, 1:]) <= tol
    # the slot engine: a prompt prefilled, then one decode step
    toks = np.random.RandomState(2).randint(0, cfg.vocab, (1, 7)) \
        .astype(np.int32)
    rl, rc = ref_tf.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                            ref_cfg, max_len=16)
    tl, tc = transformer.prefill(params, {"tokens": torch.from_numpy(toks)},
                                 cfg, max_len=16)
    assert _rel_err(np32(tl), np32(rl)) <= tol
    nxt = np.array([[int(np.argmax(np32(rl)))]], np.int32)
    rl, rc = ref_tf.decode_step(ref_params, jnp.asarray(nxt), rc, ref_cfg)
    tl, tc = transformer.decode_step(params, torch.from_numpy(nxt), tc, cfg)
    assert _rel_err(np32(tl), np32(rl)) <= tol
    for kv in ("k", "v"):
        assert _rel_err(np32(tc["layers"][kv]), np32(rc["layers"][kv])) \
            <= tol
