"""internvl2-26b in the port (the dense decoder behind an image prefix,
`models/transformer.py`) against the reference, on the reference's own
weights of the float32 smoke config (2 layers, d_model 128, GQA 4 / 2,
16 image tokens) carried across by `params_from_numpy`, inputs from
numpy seeds; the slot cache's `_splice` on every cache layout the port
serves; the launcher's --cim bp-prequant route (each layer quantized as
it is made) on internvl2-26b, rwkv6-7b and zamba2-2.7b (and the same
layer-by-layer quantization on whisper-large-v3's encoder and decoder);
the registries' families, whisper-large-v3 included.

Exact (bit for bit): the slot Server's greedy streams at --cim off,
bp-prequant and bp-noisy (noise_seed 0) and the paged Server's at
bp-prequant, on a mixed-length schedule with mid-run admission;
`_splice` against the reference's on K/V, MLA latent, RWKV6 and Mamba2 / zamba2
caches; the layer-by-layer quantized tree against the whole tree's.

Within TOL, relative to the largest |value| of the reference's output:
`forward` and `prefill` / `decode_step` with `image_embeds` (logits,
K/V). The reference runs op by op (no jit) where held to a tolerance;
its Servers run jitted, as in production.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_helpers import (leg_cfgs, mixed_depth, np32, rel_err,
                            to_numpy_tree)
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import SMOKES as REF_SMOKES  # noqa: E402
from repro.models import mamba2 as ref_mamba2  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models import rwkv6 as ref_rwkv6  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.quantize import quantize_params as ref_quantize  # noqa
from repro.runtime import server as rserver  # noqa: E402
from repro_torch.configs import registry as cfg_registry  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.models import (mamba2, registry, rwkv6,  # noqa: E402
                                transformer)
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.runtime import server as tserver  # noqa: E402

ARCH = "internvl2-26b"
MAX_LEN = 64
# forward / prefill / decode_step logits and K/V, relative to the
# reference's largest |value| (the RMSNorm's rsqrt and the float einsums
# differ from XLA:CPU's in the last bits; under bp-prequant such a bit can
# move a DAC code, so the image rows' K/V are held to TOL too); measured
# up to 1.0e-6 at --cim off and 1.5e-7 at bp-prequant
TOL = 4e-6
LEGS = ("off", "bp-prequant", "bp-noisy")


@pytest.fixture(scope="module")
def weights():
    cfg = REF_SMOKES[ARCH].replace(dtype="float32")
    params = ref_registry.init_params(jax.random.PRNGKey(0), cfg,
                                      max_seq=MAX_LEN)
    return params, to_numpy_tree(params)


def _batch(seed, t, cfg):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (1, t)).astype(np.int32)
    img = rng.standard_normal((1, cfg.n_image_tokens, cfg.d_model)) \
        .astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)},
            {"tokens": torch.from_numpy(toks),
             "image_embeds": torch.from_numpy(img)})


# ---------------------------------------------------------------------------
# the image prefix
# ---------------------------------------------------------------------------
def test_forward_with_image_embeds_matches_reference(weights):
    """The padded forward over 16 image embeddings then 9 tokens:
    positions run over the whole span, the text tokens see the image."""
    ref_cfg, cfg = leg_cfgs(ARCH, "off")
    rb, tb = _batch(1, 9, cfg)
    h_ref, _, _ = ref_tf.forward(weights[0], rb, ref_cfg, train=False)
    params = registry.params_from_numpy(weights[1], cfg, device="cpu")
    h, aux, enc = transformer.forward(params, tb, cfg, train=False)
    assert h.shape == (1, cfg.n_image_tokens + 9, cfg.d_model)
    assert aux == 0.0 and enc is None
    assert rel_err(np32(h), np32(h_ref)) <= TOL
    # without the prefix the text positions start at 0 and read otherwise
    h_text, _, _ = transformer.forward(params, {"tokens": tb["tokens"]}, cfg,
                                       train=False)
    assert h_text.shape[1] == 9
    assert not torch.allclose(h_text, h[:, cfg.n_image_tokens:])


@pytest.mark.parametrize("leg", ["off", "bp-prequant"])
def test_prefill_with_image_then_decode_matches_reference(weights, leg):
    """A prefill of 16 image embeddings and 9 tokens (pos = 25), spliced
    into slot 1 of a 2-slot cache, then a decode step at pos 25: logits
    and K/V."""
    ref_cfg, cfg = leg_cfgs(ARCH, "bp" if leg == "bp-prequant" else leg)
    rp, tp = weights[0], registry.params_from_numpy(weights[1], cfg,
                                                     device="cpu")
    if leg == "bp-prequant":
        rp, tp = ref_quantize(rp, ref_cfg), quantize_params(tp, cfg)
    rb, tb = _batch(2, 9, cfg)
    rl, rreq = ref_tf.prefill(rp, rb, ref_cfg, max_len=MAX_LEN)
    tl, treq = transformer.prefill(tp, tb, cfg, max_len=MAX_LEN)
    t = cfg.n_image_tokens + 9
    assert int(treq["pos"]) == int(rreq["pos"]) == t
    assert treq["layers"]["k"].shape == (cfg.n_layers, 1, MAX_LEN, 2, 32)
    assert rel_err(np32(tl), np32(rl)) <= TOL
    for leaf in ("k", "v"):
        assert rel_err(np32(treq["layers"][leaf]),
                        np32(rreq["layers"][leaf])) <= TOL
    rc = rserver._splice(ref_tf.init_cache(ref_cfg, 2, MAX_LEN), rreq, 1)
    tc = tserver._splice(transformer.init_cache(cfg, 2, MAX_LEN,
                                                device="cpu"), treq, 1)
    nxt = np.random.RandomState(3).randint(0, cfg.vocab, (2, 1)) \
        .astype(np.int32)
    rl, rc = ref_tf.decode_step(rp, jnp.asarray(nxt), rc, ref_cfg)
    tl, tc = transformer.decode_step(tp, torch.from_numpy(nxt), tc, cfg)
    assert int(tc["pos"]) == int(rc["pos"]) == t + 1
    assert rel_err(np32(tl), np32(rl)) <= TOL
    assert rel_err(np32(tc["layers"]["k"]), np32(rc["layers"]["k"])) <= TOL


# ---------------------------------------------------------------------------
# the Servers (text requests, as the reference Server serves the arch)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine,leg", [("slots", "off"),
                                        ("slots", "bp-prequant"),
                                        ("slots", "bp-noisy"),
                                        ("paged", "bp-prequant")])
def test_server_matches_reference(weights, engine, leg):
    """The port's Servers give the jitted reference Server's greedy streams
    (the paged one through the kernel attention, B3's plain version) and
    KV bytes."""
    ref_cfg, cfg = leg_cfgs(ARCH, "bp" if leg == "bp-prequant" else leg)
    kw = dict(n_slots=2, max_len=MAX_LEN, prequant=leg == "bp-prequant")
    if engine == "paged":
        kw.update(paged=True, block_size=8, prefill_chunk=4, attn="kernel")
    port = tserver.Server(
        registry.params_from_numpy(weights[1], cfg, device="cpu"), cfg,
        tserver.ServingConfig(**kw), device="cpu")
    out = mixed_depth(port, tserver.Request)
    ref = rserver.Server(weights[0], ref_cfg.replace(scan_layers=True),
                         rserver.ServingConfig(telemetry=False, **kw))
    assert out == mixed_depth(ref, rserver.Request)
    assert port.kv_cache_bytes() == ref.kv_cache_bytes()


# ---------------------------------------------------------------------------
# _splice on every cache layout
# ---------------------------------------------------------------------------
SPLICE_ARCHS = {"internlm2-1.8b": (ref_tf, transformer),
                "deepseek-v3-671b": (ref_tf, transformer),
                "rwkv6-7b": (ref_rwkv6, rwkv6),
                "zamba2-2.7b": (ref_mamba2, mamba2)}


@pytest.mark.parametrize("t", [5, MAX_LEN + 3])
@pytest.mark.parametrize("arch", sorted(SPLICE_ARCHS))
def test_splice_matches_reference(arch, t):
    """A 1-deep request cache of random values (a sequence axis of t rows,
    shorter or longer than max_len) into slot 2 of a 3-slot cache that
    holds other values: every leaf padded with zeros or trimmed on every
    non-batch axis, the other slots untouched, pos the max of the two; as
    the reference's `_splice` does."""
    ref_mod, mod = SPLICE_ARCHS[arch]
    ref_cfg, cfg = leg_cfgs(arch, "off")
    rng = np.random.RandomState(t)
    batched = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim else np.int32(7), ref_mod.init_cache(ref_cfg, 3, MAX_LEN))
    request = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim else np.int32(t), ref_mod.init_cache(ref_cfg, 1, t))
    ref = rserver._splice(jax.tree.map(jnp.asarray, batched),
                          jax.tree.map(jnp.asarray, request), 2)
    tb = jax.tree.map(torch.from_numpy, jax.tree.map(np.array, batched))
    out = tserver._splice(tb, jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), request), 2)
    assert out is tb                                  # in place
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(leaves) == len(jax.tree.leaves(out)) > 1
    for path, r in leaves:
        node = out
        for key in path:
            node = node[key.key]
        assert np.array_equal(node.numpy(), np.asarray(r)), path
    assert int(out["pos"]) == max(7, t)
    # a transformer's request K/V carry the sequence on axis 2; the
    # recurrent leaves have no sequence axis, so t changes nothing there
    assert mod.init_cache(cfg, 3, MAX_LEN, device="cpu").keys() \
        == ref.keys()


# ---------------------------------------------------------------------------
# the registries
# ---------------------------------------------------------------------------
def test_families_and_whisper_still_raises():
    """vlm, ssm, hybrid and audio resolve to their modules, as in the
    reference's registry; whisper-large-v3 (family audio: an encoder,
    cross-attention, learned positions; ported last, ROADMAP A9b) no
    longer raises: it is in the arch registry and its smoke model
    initialises with its learned positions (what raises now is learned
    positions without max_seq, as the reference's init asserts)."""
    for arch, mod in (("internvl2-26b", transformer), ("rwkv6-7b", rwkv6),
                      ("zamba2-2.7b", mamba2),
                      ("whisper-large-v3", transformer)):
        assert registry.get_module(SMOKES[arch]) is mod
        assert ref_registry.get_module(REF_SMOKES[arch]).__name__ \
            == "repro.models." + mod.__name__.rsplit(".", 1)[1]
        assert cfg_registry.get(arch) == cfg_registry.ARCHS[arch]
    whisper = REF_SMOKES["whisper-large-v3"]
    fields = {f.name: getattr(whisper, f.name)
              for f in dataclasses.fields(whisper) if f.name != "cim"}
    cfg = SMOKES[ARCH].replace(**fields)
    assert cfg == SMOKES["whisper-large-v3"]
    assert cfg.family == "audio" and cfg.encoder_layers > 0
    with pytest.raises(ValueError, match="max_seq"):
        transformer.init(cfg, device="cpu")
    p = transformer.init(cfg, device="cpu", max_seq=MAX_LEN)
    assert len(p["enc_layers"]) == cfg.encoder_layers


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ["internvl2-26b", "rwkv6-7b",
                                  "zamba2-2.7b", "whisper-large-v3"])
def test_layer_by_layer_quantization_equals_the_whole_tree(arch):
    """The launcher's --cim bp-prequant route quantizes each layer as it is
    made and the Server then quantizes what is left (the embedding and
    head), passing the stored codes through: the same tree, leaf for leaf,
    as quantizing the whole float model at once."""
    cfg = leg_cfgs(arch, "bp-prequant")[1]
    whole = quantize_params(registry.init_params(
        cfg, seed=3, device="cpu", max_seq=MAX_LEN), cfg)
    by_layer = quantize_params(registry.init_params(
        cfg, seed=3, device="cpu", max_seq=MAX_LEN,
        layer_fn=lambda lp: quantize_params(lp, cfg)), cfg)
    a, b = list(_leaves(whole)), list(_leaves(by_layer))
    assert [p for p, _ in a] == [p for p, _ in b]
    assert any(p.endswith("w_in_q") or p.endswith("wq_q") or
               p.endswith("w_r_q") for p, _ in a)
    for (p, x), (_, y) in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), p
        else:
            assert x == y, p


@pytest.mark.parametrize("arch,extra", [("internvl2-26b", ["--paged"]),
                                        ("rwkv6-7b", []),
                                        ("zamba2-2.7b", [])])
def test_serve_launcher_new_archs_on_cpu(arch, extra, capsys):
    """`python -m repro_torch.launch.serve --arch ... --smoke --cim
    bp-prequant --device cpu` serves every request through the layer-by-
    layer quantized model on the arch's engine."""
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--smoke", "--requests", "2", "--max-new",
                "3", "--cim", "bp-prequant", "--device", "cpu",
                "--max-len", "64"] + extra)
    out = capsys.readouterr().out
    engine = "paged" if extra else "slots"
    assert out.count("req") >= 2 and f"engine={engine}" in out
    assert "tok/s" in out
