"""The port's Hopper kernels against their plain PyTorch versions, on the
card (marker `gpu`; each test skips without a CUDA device). Run there with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

B1, B2, B4, B5 and B6 must be bit-exact (B2/B5 at every macro depth,
B1/B6 at every even one) (B5/B6 at NOISY and at FULL: the
kernel's sinf and torch.sin on the card are the same CUDA sinf); B3 too,
since its plain version follows the kernel's operation order on the same
device, with a bfloat16 output equal to the plain f32 output rounded by
`.to(torch.bfloat16)`. B4 runs inside B3's decode launch: that launch
must equal B4's plain version followed by B3's, on the outputs and on
every byte of both pools. B3 and that launch are held so at head dims and
block sizes past their fast case too (dh 16, 20, 21, 56, 80, 96; bs 48,
64, 128), and a speculative verify step (C = 5, every position's logits)
of the smoke model is identical with the kernels and with their plain
versions, as is a telemetry-on serve with parallel samples and the trie
watermark sweep (streams, metrics and event kinds), and the slot engine's
prefill, decode step and serve (logits, caches, streams, metrics). B1,
B2, B5 and B6 are also held at every ADC level of the precision search's
ladder (32 to 256), and a paged prefill and decode step under a precision
manifest (per-site static grids, 128 / 181 / 45 levels, a WBS site, a
per-channel site) is identical with the kernels and with their plain
versions, as is a lane's stream under the static grid alone and beside
companions. B1 and B6's expert-batched entries (the MoE routed experts)
equal their plain versions and one 2-D launch per expert, bit for bit, and
the smoke qwen2-moe's paged steps and slot serve are identical with the
kernels and with their plain versions; so do B2 and B5's (the float
routed experts at --cim bp / bp-noisy), and the smoke deepseek-v3's slot
prefill, decode step and serve (MLA, a leading dense layer, the experts
through B2 / B5's expert-batched entry). So are the smoke rwkv6-7b's and
zamba2-2.7b's slot prefill and decode step (their recurrent caches too)
and internvl2-26b's image-prefix prefill and decode step, at IDEAL (B1)
and NOISY (B6), and zamba2's at --cim bp-noisy (B5); so is one
full-width whisper-large-v3 layer's prefill (an encoder layer over 300
frames, a decoder layer with cross-attention) and decode step at IDEAL,
NOISY and bp-noisy, and the KWS GRU's forward at IDEAL and FULL from
float weights (B2, B5) and stored codes (B1, B6). Training: cim_matmul's
and cim_matmul_prequant's gradients (through the einsum VJP) and
cim_matmul_ste's are identical with the kernels and with their plain
versions, no kernel launching in a backward; two train steps of the
smoke internlm2 at --cim bp (IDEAL and NOISY) are identical with the
kernels and with their plain versions (29 launches a step), a step is
deterministic run to run, and the embedding gather's backward equals the
CPU's bit for bit. The A10b legs: cim_matmul_ste on an expert stack (B2e
forward, per-expert products backward) is identical with the kernel and
with its plain version, the MoE dispatch's backward equals the CPU's, one
step of each smoke qwen2-moe, deepseek-v3, rwkv6, zamba2, whisper and
internvl2 at --cim bp is identical with the kernels and with their plain
versions, and the MoE archs' steps are deterministic run to run. The
paper's figures: B2 at their shapes (the classifier's x [1024, 64] x
[64, 144], a single partial group, and [1024, 144] x [144, 16];
quickstart's [8, 288] x [288, 16]) at each of Fig. 10's ADC ladders (32
... 1024) equals its plain version, and Fig. 10 through figures.run on the
card launches B2 14 times, each rung's logits equal with the kernel and
with its plain version. Inputs come from numpy seeds. This file needs no
JAX.
"""
import importlib

import numpy as np
import pytest
import torch

from _torch_helpers import gpu_device

from repro_torch.kernels import cim_mvm, ops
from repro_torch.kernels import paged_attention as pa

pytestmark = pytest.mark.gpu

KW = dict(n_rows=144, levels=362, gain=1.0, full_scale=32400.0)


def _codes(seed, shape):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 16, shape).astype(np.float32))


# the last four: group counts that are no multiple of the packed MVM's
# cluster size (G = 15, 11, 11, 63 over clusters of 4, 6, 2, 8 CTAs) and K
# no multiple of the 144-row group (2047 is odd: its last byte row holds
# one code)
SHAPES = [(1, 1, 1), (3, 301, 70), (5, 288, 129), (130, 145, 257),
          (4, 2048, 2048), (64, 2048, 1024), (4, 8192, 2048),
          (1, 2047, 1024), (8, 1500, 96), (64, 1441, 160), (4, 9000, 48)]
NOISY = dict(KW, sigma=0.277)
FULL = dict(KW, sigma=0.277, inl_amp=1.1, apply_inl=True)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_b1_b2_bit_exact_vs_plain(m, k, n):
    dev = gpu_device()
    x = _codes(m, (m, k)).to(dev)
    w = _codes(n, (k, n)).to(dev)
    wp = ops.pack_codes(w).contiguous()
    before = cim_mvm.cim_mvm_grouped.launches
    assert torch.equal(cim_mvm.cim_mvm_grouped(x, w, **KW),
                       cim_mvm.cim_mvm_grouped_plain(x, w, **KW))
    assert torch.equal(cim_mvm.cim_mvm_grouped_packed(x, wp, **KW),
                       cim_mvm.cim_mvm_grouped_packed_plain(x, wp, **KW))
    assert cim_mvm.cim_mvm_grouped.launches == before + 1


@pytest.mark.parametrize("level", ["noisy", "full"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_b5_b6_bit_exact_vs_plain(m, k, n, level):
    dev = gpu_device()
    x = _codes(m + 1, (m, k)).to(dev)
    w = _codes(n + 1, (k, n)).to(dev)
    wp = ops.pack_codes(w).contiguous()
    kw = NOISY if level == "noisy" else FULL
    for seed, inl_seed in ((0, 0), (7, 3)):
        s = torch.tensor([seed], dtype=torch.int32, device=dev)
        y5 = cim_mvm.cim_mvm_grouped_noisy(x, w, s, inl_seed=inl_seed, **kw)
        y6 = cim_mvm.cim_mvm_grouped_noisy_packed(x, wp, s, inl_seed=inl_seed,
                                                  **kw)
        assert torch.isfinite(y5).all()
        assert torch.equal(y5, cim_mvm.cim_mvm_grouped_noisy_plain(
            x, w, s, inl_seed=inl_seed, **kw))
        assert torch.equal(y6, cim_mvm.cim_mvm_grouped_noisy_packed_plain(
            x, wp, s, inl_seed=inl_seed, **kw))
        assert torch.equal(y6, y5)


@pytest.mark.parametrize("level", ["ideal", "noisy"])
def test_b1_b6_groups_of_rows_not_a_multiple_of_four(level):
    """146-row groups split a four-row int8 word across two groups, so the
    packed MVM takes the one-block-per-32-columns body there; it stays
    bit-exact against the plain versions."""
    dev = gpu_device()
    kw = dict(KW, n_rows=146)
    x = _codes(11, (4, 700)).to(dev)
    wp = ops.pack_codes(_codes(12, (700, 96)).to(dev)).contiguous()
    if level == "ideal":
        assert torch.equal(cim_mvm.cim_mvm_grouped_packed(x, wp, **kw),
                           cim_mvm.cim_mvm_grouped_packed_plain(x, wp, **kw))
        return
    s = torch.tensor([7], dtype=torch.int32, device=dev)
    kw = dict(kw, sigma=0.277)
    assert torch.equal(
        cim_mvm.cim_mvm_grouped_noisy_packed(x, wp, s, **kw),
        cim_mvm.cim_mvm_grouped_noisy_packed_plain(x, wp, s, **kw))


# (E, M, K, N, n_rows) of the expert-batched B1 / B6: qwen2-moe's decode
# shapes at full width (64 experts of capacity 8), the smoke model's, the
# 4-row tile (M <= 4), an odd K, warps side by side, and 146-row groups
# (the one-block-per-32-columns body)
EXPERT_SHAPES = [(64, 8, 2048, 1408, 144), (64, 8, 1408, 2048, 144),
                 (16, 8, 128, 64, 144), (16, 8, 64, 128, 144),
                 (5, 3, 301, 70, 144), (3, 4, 2047, 1024, 144),
                 (4, 64, 2048, 4096, 144), (6, 8, 700, 96, 146)]


@pytest.mark.parametrize("level", ["ideal", "noisy", "full"])
@pytest.mark.parametrize("e,m,k,n,n_rows", EXPERT_SHAPES)
def test_b1_b6_experts_bit_exact(e, m, k, n, n_rows, level):
    """One expert-batched launch equals its plain version and one 2-D
    launch per expert; every expert draws the 2-D kernel's noise (the
    hash takes no expert index)."""
    dev = gpu_device()
    kw = dict(KW, n_rows=n_rows)
    if level != "ideal":
        kw.update({k_: v for k_, v in (NOISY if level == "noisy"
                                       else FULL).items() if k_ not in KW})
    x = _codes(e + m, (e, m, k)).to(dev)
    wp = ops.pack_codes(_codes(n + k, (e, k, n)).to(dev)).contiguous()
    if level == "ideal":
        fn, wrapper = (cim_mvm.cim_mvm_grouped_packed_experts,
                       cim_mvm.cim_mvm_grouped_packed)
        plain = cim_mvm.cim_mvm_grouped_packed_experts_plain
        args = ()
    else:
        fn, wrapper = (cim_mvm.cim_mvm_grouped_noisy_packed_experts,
                       cim_mvm.cim_mvm_grouped_noisy_packed)
        plain = cim_mvm.cim_mvm_grouped_noisy_packed_experts_plain
        args = (torch.tensor([7], dtype=torch.int32, device=dev),)
    before = fn.launches
    y = fn(x, wp, *args, **kw)
    assert fn.launches == before + 1 and y.shape == (e, m, n)
    assert torch.equal(y, plain(x, wp, *args, **kw))
    assert torch.equal(y, torch.stack([wrapper(x[i], wp[i], *args, **kw)
                                       for i in range(e)]))


def test_experts_reject_bad_operands():
    dev = gpu_device()
    x = _codes(1, (4, 8, 288)).to(dev)
    wp = ops.pack_codes(_codes(2, (4, 288, 32)).to(dev)).contiguous()
    with pytest.raises(ValueError, match="3-D"):
        cim_mvm.cim_mvm_grouped_packed_experts(x[0], wp, **KW)
    with pytest.raises(ValueError, match="shape mismatch"):
        cim_mvm.cim_mvm_grouped_packed_experts(x[:3].contiguous(), wp, **KW)
    with pytest.raises(ValueError, match="CUDA"):
        cim_mvm.cim_mvm_grouped_packed_experts(x, wp.cpu(), **KW)
    with pytest.raises(ValueError, match="even"):
        cim_mvm.cim_mvm_grouped_packed_experts(x, wp, **dict(KW, n_rows=9))


# (E, M, K, N, n_rows) of the expert-batched B2 / B5: deepseek-v3's expert
# widths on fewer experts (capacity 8; K 7168 -> N 256 and K 2048 -> N
# 896), the smoke model's, the 4-row tile, an odd K, warps side by side
# (N 4096 at M > 4), N % 4 != 0 (scalar weight loads), depth 9, and
# groups staged in passes (n_rows 1, no cluster)
DENSE_EXPERT_SHAPES = [(16, 8, 7168, 256, 144), (16, 8, 2048, 896, 144),
                       (16, 8, 128, 64, 144), (16, 8, 64, 128, 144),
                       (5, 3, 301, 70, 144), (3, 4, 2047, 1024, 144),
                       (4, 64, 2048, 4096, 144), (4, 8, 1500, 18, 144),
                       (6, 8, 700, 96, 9), (2, 4, 12000, 16, 1)]


@pytest.mark.parametrize("level", ["ideal", "noisy", "full"])
@pytest.mark.parametrize("e,m,k,n,n_rows", DENSE_EXPERT_SHAPES)
def test_b2_b5_experts_bit_exact(e, m, k, n, n_rows, level):
    """One expert-batched B2 / B5 launch equals its plain version and one
    2-D launch per expert; every expert draws the 2-D kernel's noise."""
    dev = gpu_device()
    kw = _depth_kw(n_rows, level)
    x = _codes(e + m, (e, m, k)).to(dev)
    w = _codes(n + k, (e, k, n)).to(dev)
    if level == "ideal":
        fn, wrapper = (cim_mvm.cim_mvm_grouped_experts,
                       cim_mvm.cim_mvm_grouped)
        plain = cim_mvm.cim_mvm_grouped_experts_plain
        args = ()
    else:
        fn, wrapper = (cim_mvm.cim_mvm_grouped_noisy_experts,
                       cim_mvm.cim_mvm_grouped_noisy)
        plain = cim_mvm.cim_mvm_grouped_noisy_experts_plain
        args = (torch.tensor([7], dtype=torch.int32, device=dev),)
    before = fn.launches
    y = fn(x, w, *args, **kw)
    assert fn.launches == before + 1 and y.shape == (e, m, n)
    assert torch.equal(y, plain(x, w, *args, **kw))
    assert torch.equal(y, torch.stack([wrapper(x[i], w[i], *args, **kw)
                                       for i in range(e)]))


def test_dense_experts_reject_bad_operands():
    dev = gpu_device()
    x = _codes(1, (4, 8, 288)).to(dev)
    w = _codes(2, (4, 288, 32)).to(dev)
    with pytest.raises(ValueError, match="3-D"):
        cim_mvm.cim_mvm_grouped_experts(x[0], w, **KW)
    with pytest.raises(ValueError, match="shape mismatch"):
        cim_mvm.cim_mvm_grouped_experts(x[:3].contiguous(), w, **KW)
    with pytest.raises(ValueError, match="shape mismatch"):
        cim_mvm.cim_mvm_grouped_experts(x[..., :200].contiguous(), w, **KW)
    with pytest.raises(ValueError, match="CUDA"):
        cim_mvm.cim_mvm_grouped_experts(x, w.cpu(), **KW)
    with pytest.raises(ValueError, match="float32"):
        cim_mvm.cim_mvm_grouped_experts(x, w.to(torch.uint8), **KW)


@pytest.mark.parametrize("level", ["ideal", "noisy"])
def test_deepseek_steps_kernels_bit_exact_vs_plain(level):
    """The smoke deepseek-v3 at --cim bp (NOISY at noise_seed 0): a slot
    prefill and a decode step are identical with the kernels (B2, B2e at
    IDEAL; B5, B5e at NOISY) and with their plain versions, logits and
    both latent stacks, with 3 expert-batched launches per MoE layer and
    forward; so are a slot serve's streams and metrics."""
    import dataclasses
    from repro_torch.configs.registry import SMOKES
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.core.macro import SimLevel
    from repro_torch.kernels import build
    from repro_torch.models import registry, transformer
    from repro_torch.runtime.server import (Request, Server, ServingConfig,
                                            _splice)
    dev = gpu_device()
    cim = CIMConfig(enabled=True)
    if level == "noisy":
        cim = dataclasses.replace(cim, noise_seed=0, macro=dataclasses.replace(
            cim.macro, sim_level=SimLevel.NOISY))
    cfg = SMOKES["deepseek-v3-671b"].replace(cim=cim)
    plain = cfg.replace(cim=dataclasses.replace(cim, backend="plain"))
    params = registry.init_params(cfg, seed=0, device=dev)
    rng = np.random.RandomState(21)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (1, 11))).to(dev)
    nxt = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 1))).to(dev)
    outs = []
    build.reset_launch_counts()
    for c in (cfg, plain):
        l1, rcache = transformer.prefill(params, {"tokens": toks}, c,
                                         max_len=32)
        cache = _splice(transformer.init_cache(c, 2, 32, device=dev), rcache,
                        1)
        l2, cache = transformer.decode_step(params, nxt, cache, c)
        outs.append((l1, l2, cache["dense_layers"]["latent"],
                     cache["layers"]["latent"]))
    counts = build.launch_counts()
    batched = "cim_mvm_grouped_experts" if level == "ideal" \
        else "cim_mvm_grouped_noisy_experts"
    assert counts[batched] == 2 * 3 * (cfg.n_layers - cfg.moe.first_dense)
    for a, b in zip(*outs):
        assert torch.equal(a, b)

    def serve(c):
        srv = Server(params, c, ServingConfig(n_slots=2, max_len=64),
                     device=dev)
        r2 = np.random.RandomState(19)
        reqs = [Request(prompt=r2.randint(0, c.vocab, size=int(n)).tolist(),
                        max_new_tokens=5) for n in (5, 30, 9)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        return [r.output for r in reqs], srv.steps_run

    assert serve(cfg) == serve(plain)


@pytest.mark.parametrize("level", ["ideal", "noisy", "bp-noisy"])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b",
                                  "internvl2-26b"])
def test_a9b_slot_steps_kernels_bit_exact_vs_plain(arch, level):
    """The smoke rwkv6-7b, zamba2-2.7b and internvl2-26b (packed prequant;
    NOISY at noise_seed 0; bp-noisy: float weights through B5): a slot
    prefill (internvl2's behind 16 numpy-seeded image embeddings) spliced
    into slot 1 and a decode step are identical with the kernels and with
    their plain versions: logits and every cache leaf (the token-shift
    carries and WKV state, the conv history, SSD state and shared K/V, the
    K/V), one launch per stored matrix and forward."""
    import dataclasses
    from repro_torch.configs.registry import SMOKES
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.core.macro import SimLevel
    from repro_torch.kernels import build
    from repro_torch.models import registry
    from repro_torch.models.quantize import quantize_params
    from repro_torch.runtime.server import _splice
    dev = gpu_device()
    cim = CIMConfig(enabled=True)
    if level != "ideal":
        cim = dataclasses.replace(cim, noise_seed=0, macro=dataclasses.replace(
            cim.macro, sim_level=SimLevel.NOISY))
    cfg = SMOKES[arch].replace(cim=cim)
    plain = cfg.replace(cim=dataclasses.replace(cim, backend="plain"))
    mod = registry.get_module(cfg)
    params = registry.init_params(cfg, seed=0, device=dev)
    if level != "bp-noisy":
        params = quantize_params(params, cfg)
    rng = np.random.RandomState(23)
    batch = {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab,
                                                    (1, 21))).to(dev)}
    if cfg.n_image_tokens:
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (1, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)).to(dev)
    nxt = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 1))).to(dev)
    outs = []
    build.reset_launch_counts()
    for c in (cfg, plain):
        l1, rcache = mod.prefill(params, batch, c, max_len=64)
        cache = _splice(mod.init_cache(c, 2, 64, device=dev), rcache, 1)
        l2, cache = mod.decode_step(params, nxt, cache, c)
        outs.append([l1, l2] + [t for st in sorted(cache) if st != "pos"
                                for _, t in sorted(cache[st].items())])
    kname = {"ideal": "cim_mvm_grouped_packed",
             "noisy": "cim_mvm_grouped_noisy_packed",
             "bp-noisy": "cim_mvm_grouped_noisy"}[level]
    # one launch per stored matrix and forward (the head included; zamba2's
    # shared block at each of its 2 applications), in the kernels' forwards
    per_fwd = {"rwkv6-7b": 2 * 8, "zamba2-2.7b": 6 * 2 + 2 * 7,
               "internvl2-26b": 2 * 7}[arch] + 1
    assert build.launch_counts()[kname] == 2 * per_fwd
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("level", ["ideal", "noisy", "bp-noisy"])
def test_whisper_layer_kernels_bit_exact_vs_plain(level):
    """whisper-large-v3 at full width (d_model 1280, 20 heads of 64, d_ff
    5120, vocab 51866) cut to one encoder and one decoder layer, in bf16:
    a prefill of 2 x 4 tokens over 300 numpy-seeded frames and a decode
    step are identical with the kernels (packed prequant: B1, NOISY B6;
    bp-noisy: float weights through B5) and with their plain versions,
    logits and every cache leaf (self and cross K/V); 6 + 10 + 1 launches
    a prefill (the encoder layer, the decoder layer with its cross K/V
    over the frames, the head), 8 + 1 a decode step."""
    import dataclasses
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.core.macro import SimLevel
    from repro_torch.kernels import build
    from repro_torch.models import registry, transformer
    from repro_torch.models.quantize import quantize_params
    dev = gpu_device()
    cim = CIMConfig(enabled=True)
    if level != "ideal":
        cim = dataclasses.replace(cim, noise_seed=0, macro=dataclasses.replace(
            cim.macro, sim_level=SimLevel.NOISY))
    cfg = ARCHS["whisper-large-v3"].replace(n_layers=1, encoder_layers=1,
                                            cim=cim)
    plain = cfg.replace(cim=dataclasses.replace(cim, backend="plain"))
    params = registry.init_params(cfg, seed=0, device=dev, max_seq=448)
    if level != "bp-noisy":
        params = quantize_params(params, cfg)
    rng = np.random.RandomState(29)
    batch = {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab,
                                                    (2, 4))).to(dev),
             "frames": torch.from_numpy(rng.standard_normal(
                 (2, 300, cfg.d_model)).astype(np.float32)).to(dev)}
    outs = []
    build.reset_launch_counts()
    for c in (cfg, plain):
        l1, cache = transformer.prefill(params, batch, c, max_len=448)
        l2, cache = transformer.decode_step(params, l1.argmax(-1)[:, None],
                                            cache, c)
        outs.append([l1, l2] + [cache[st][leaf] for st in ("layers", "cross")
                                for leaf in ("k", "v")])
    kname = {"ideal": "cim_mvm_grouped_packed",
             "noisy": "cim_mvm_grouped_noisy_packed",
             "bp-noisy": "cim_mvm_grouped_noisy"}[level]
    assert build.launch_counts()[kname] == (6 + 10 + 1) + (8 + 1)
    assert outs[0][4].shape == (1, 2, 300, 20, 64)
    for a, b in zip(*outs):
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a, b)


@pytest.mark.parametrize("level,stored", [("ideal", False), ("ideal", True),
                                          ("full", False), ("full", True)])
def test_gru_forward_kernels_bit_exact_vs_plain(level, stored):
    """The KWS GRU (d 144, gates [288, 144], 12 classes) over 64 x 12
    numpy-seeded frames on the macro at gain 3 and 0.65 V (FULL with
    noise_seed 0): logits identical with the kernels (B2 / B1 at IDEAL,
    B5 / B6 at FULL) and with their plain versions, 3 launches a frame
    and one for the head."""
    import dataclasses
    from repro_torch.core.macro import SimLevel
    from repro_torch.examples.kws_gru import macro_cfg
    from repro_torch.kernels import build
    from repro_torch.models import gru
    from repro_torch.models.quantize import quantize_params
    dev = gpu_device()
    cfg = macro_cfg(gru.gru_config(n_classes=12), vdd=0.65,
                    level=SimLevel(level),
                    noise_seed=0 if level == "full" else None)
    plain = cfg.replace(cim=dataclasses.replace(cfg.cim, backend="plain"))
    params = gru.init(cfg, seed=3, device=dev)
    if stored:
        params = quantize_params(params, cfg)
    frames = torch.from_numpy(np.maximum(np.random.RandomState(31)
                                         .standard_normal((64, 12, 144)),
                                         0).astype(np.float32)).to(dev)
    build.reset_launch_counts()
    out = gru.forward(params, frames, cfg)
    kname = {(False, "ideal"): "cim_mvm_grouped",
             (True, "ideal"): "cim_mvm_grouped_packed",
             (False, "full"): "cim_mvm_grouped_noisy",
             (True, "full"): "cim_mvm_grouped_noisy_packed"}[stored, level]
    assert build.launch_counts()[kname] == 3 * 12 + 1
    assert torch.equal(out, gru.forward(params, frames, plain))


@pytest.mark.parametrize("level", ["ideal", "noisy"])
def test_moe_steps_kernels_bit_exact_vs_plain(level):
    """The smoke qwen2-moe (packed prequant; NOISY at noise_seed 0): a
    paged prefill chunk and a decode step, and a slot-engine serve, are
    identical with the kernels (B1, B1 / B6 expert-batched, B3 and the
    decode launch) and with their plain versions."""
    import dataclasses
    from repro_torch.configs.registry import SMOKES
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.core.macro import SimLevel
    from repro_torch.kernels import build
    from repro_torch.models import registry, transformer
    from repro_torch.models.quantize import quantize_params
    dev = gpu_device()
    cim = CIMConfig(enabled=True)
    if level == "noisy":
        cim = dataclasses.replace(cim, noise_seed=0, macro=dataclasses.replace(
            cim.macro, sim_level=SimLevel.NOISY))
    cfg = SMOKES["qwen2-moe-a2.7b"].replace(cim=cim, attn_backend="kernel")
    plain = cfg.replace(attn_backend="plain",
                        cim=dataclasses.replace(cim, backend="plain"))
    params = quantize_params(registry.init_params(cfg, seed=0, device=dev),
                             cfg)
    rng = np.random.RandomState(20)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 8))).to(dev)
    nxt = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 1))).to(dev)
    tables = torch.arange(1, 9, dtype=torch.int32, device=dev).reshape(4, 2)
    valid = torch.tensor([8, 5, 0, 8], device=dev)
    outs = []
    build.reset_launch_counts()
    for c in (cfg, plain):
        cache = transformer.init_paged_cache(c, 9, 8, device=dev)
        l1, cache = transformer.paged_step(
            params, toks, cache, tables, torch.zeros(4, dtype=torch.long,
                                                     device=dev), valid, c)
        l2, cache = transformer.paged_step(
            params, nxt, cache, tables, valid,
            torch.tensor([1, 1, 0, 1], device=dev), c)
        # blocks >= 1: the trash block takes masked writes by design
        outs.append((l1, l2, cache["layers"]["k"][:, 1:],
                     cache["layers"]["v"][:, 1:]))
    counts = build.launch_counts()
    batched = "cim_mvm_grouped_packed_experts" if level == "ideal" \
        else "cim_mvm_grouped_noisy_packed_experts"
    assert counts[batched] == 2 * 3 * cfg.n_layers
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    kern = _slot_serve(cfg, dev)
    assert kern == _slot_serve(plain, dev)


# Shapes that reach each path of the dense MVM's dispatch (B2/B5), as
# (M, K, N, n_rows): clusters of 1 (w_gate/w_up, the head, most prefill
# shapes), 2 (wq/wo, wk/wv, w_down), 4 and 8 CTAs (small N; prefill
# w_down, where a CTA must stay within half an SM's shared memory; 228
# groups of 9 rows), with group counts that are no multiple of the
# cluster size (15 over 2, 57 over 4, 10 over 4, 63 over 8); N % 4 != 0
# (scalar weight loads); warps side by side (N = 4096 and 8192 at M > 4);
# M from 1 to 130; the macro depths 9, 145 and 1024; groups staged in
# passes where no cluster holds them (n_rows = 1, K = 12000) and one
# group's rows in windows (n_rows = 7400). SHAPES above reach clusters of
# 2 to 8 as well.
DENSE_SHAPES = [
    (4, 2048, 2048, 144), (4, 2048, 1024, 144), (4, 2048, 8192, 144),
    (4, 8192, 2048, 144), (64, 2048, 2048, 144), (64, 8192, 2048, 144),
    (65, 2048, 4096, 144), (2, 1300, 300, 144), (4, 2048, 18, 144),
    (4, 2048, 2050, 144), (9, 3000, 514, 144), (17, 700, 1026, 144),
    (3, 301, 70, 144), (1, 2047, 1024, 144), (130, 145, 257, 144),
    (4, 2048, 2048, 9), (64, 2048, 2048, 9), (4, 2048, 2048, 145),
    (64, 2048, 2048, 145), (4, 2048, 2048, 1024), (64, 2048, 2048, 1024),
    (64, 2048, 1024, 9), (4, 9000, 48, 144), (4, 12000, 16, 1),
    (9, 14800, 40, 7400), (5, 1500, 520, 144), (8, 1500, 520, 144),
    (16, 1500, 520, 144), (33, 1500, 520, 144), (100, 1500, 520, 144)]


def _depth_kw(n_rows, level):
    kw = dict(KW, n_rows=n_rows, full_scale=225.0 * n_rows)
    if level == "ideal":
        return kw
    return dict(kw, **{k: v for k, v in (NOISY if level == "noisy"
                                         else FULL).items() if k not in KW})


@pytest.mark.parametrize("level", ["ideal", "noisy", "full"])
@pytest.mark.parametrize("m,k,n,n_rows", DENSE_SHAPES)
def test_b2_b5_dense_paths_bit_exact_vs_plain(m, k, n, n_rows, level):
    """B2 (IDEAL) and B5 (NOISY, FULL) against their plain versions on
    every path of the dense dispatch; B6 equal to B5 where the depth is
    one the packed kernels take."""
    dev = gpu_device()
    x = _codes(m + 2, (m, k)).to(dev)
    w = _codes(n + 2, (k, n)).to(dev)
    kw = _depth_kw(n_rows, level)
    if level == "ideal":
        before = cim_mvm.cim_mvm_grouped.launches
        assert torch.equal(cim_mvm.cim_mvm_grouped(x, w, **kw),
                           cim_mvm.cim_mvm_grouped_plain(x, w, **kw))
        assert cim_mvm.cim_mvm_grouped.launches == before + 1
        return
    s = torch.tensor([7], dtype=torch.int32, device=dev)
    y5 = cim_mvm.cim_mvm_grouped_noisy(x, w, s, inl_seed=3, **kw)
    assert torch.isfinite(y5).all()
    assert torch.equal(y5, cim_mvm.cim_mvm_grouped_noisy_plain(
        x, w, s, inl_seed=3, **kw))
    if n_rows % 2 == 0 and n_rows <= cim_mvm.PACKED_MAX_ROWS:
        wp = ops.pack_codes(w).contiguous()
        assert torch.equal(cim_mvm.cim_mvm_grouped_noisy_packed(
            x, wp, s, inl_seed=3, **kw), y5)


@pytest.mark.parametrize("level", ["ideal", "noisy"])
@pytest.mark.parametrize("m", [4, 64])
def test_b2_b5_weights_not_16_byte_aligned(m, level):
    """A contiguous w at a storage offset of one element: the dense
    kernel takes scalar loads instead of 16-byte ones."""
    dev = gpu_device()
    k, n = 2048, 1024
    x = _codes(5, (m, k)).to(dev)
    store = torch.zeros(k * n + 1, device=dev)
    w = store[1:].view(k, n)
    w.copy_(_codes(6, (k, n)).to(dev))
    assert w.is_contiguous() and w.data_ptr() % 16 != 0
    if level == "ideal":
        assert torch.equal(cim_mvm.cim_mvm_grouped(x, w, **KW),
                           cim_mvm.cim_mvm_grouped_plain(x, w, **KW))
        return
    s = torch.tensor([0], dtype=torch.int32, device=dev)
    assert torch.equal(cim_mvm.cim_mvm_grouped_noisy(x, w, s, **NOISY),
                       cim_mvm.cim_mvm_grouped_noisy_plain(x, w, s, **NOISY))


@pytest.mark.parametrize("n_rows", [426, 1024])
@pytest.mark.parametrize("m", [4, 64])
def test_b1_b6_deep_groups(m, n_rows):
    """Deep even groups: 1024 rows take the packed cluster kernel, 426
    rows (no multiple of four) the fallback body, which at M > 4 stages
    fewer than 16 groups per pass to fit its shared memory."""
    dev = gpu_device()
    kw = _depth_kw(n_rows, "ideal")
    x = _codes(m + 50, (m, 3000)).to(dev)
    w = _codes(51, (3000, 200)).to(dev)
    wp = ops.pack_codes(w).contiguous()
    y2 = cim_mvm.cim_mvm_grouped(x, w, **kw)
    assert torch.equal(cim_mvm.cim_mvm_grouped_packed(x, wp, **kw), y2)
    assert torch.equal(y2, cim_mvm.cim_mvm_grouped_plain(x, w, **kw))
    nkw = _depth_kw(n_rows, "noisy")
    s = torch.tensor([7], dtype=torch.int32, device=dev)
    assert torch.equal(
        cim_mvm.cim_mvm_grouped_noisy_packed(x, wp, s, **nkw),
        cim_mvm.cim_mvm_grouped_noisy(x, w, s, **nkw))


def test_dense_takes_odd_depths_packed_rejects_them():
    dev = gpu_device()
    kw = _depth_kw(9, "ideal")
    x = _codes(60, (4, 300)).to(dev)
    w = _codes(61, (300, 40)).to(dev)
    assert torch.equal(cim_mvm.cim_mvm_grouped(x, w, **kw),
                       cim_mvm.cim_mvm_grouped_plain(x, w, **kw))
    with pytest.raises(ValueError, match="even macro depth"):
        cim_mvm.cim_mvm_grouped_packed(x, ops.pack_codes(w).contiguous(),
                                       **kw)


def test_b5_seed_is_read_on_the_card():
    """A new seed value in the same tensor changes the draws (no rebuild,
    no host copy), and inl_seed salts them."""
    dev = gpu_device()
    x = _codes(3, (4, 2048)).to(dev)
    w = _codes(4, (2048, 256)).to(dev)
    s = torch.zeros(1, dtype=torch.int32, device=dev)
    y0 = cim_mvm.cim_mvm_grouped_noisy(x, w, s, **NOISY)
    s.fill_(7)
    y7 = cim_mvm.cim_mvm_grouped_noisy(x, w, s, **NOISY)
    assert not torch.equal(y0, y7)
    assert not torch.equal(y7, cim_mvm.cim_mvm_grouped_noisy(
        x, w, s, inl_seed=3, **NOISY))
    with pytest.raises(ValueError, match="seed"):
        cim_mvm.cim_mvm_grouped_noisy(x, w, s.cpu(), **NOISY)


def test_b1_rejects_bad_operands():
    dev = gpu_device()
    x = _codes(0, (4, 300)).to(dev)
    with pytest.raises(ValueError):
        cim_mvm.cim_mvm_grouped_packed(x, torch.zeros(10, 8, dtype=torch.uint8,
                                                      device=dev), **KW)
    with pytest.raises(ValueError):
        cim_mvm.cim_mvm_grouped_packed(x, torch.zeros(150, 8, device=dev),
                                       **KW)


def _attn_case(seed, c, dtype, dev, b=4, kh=8, g=2, dh=128, bs=16, mb=16):
    """Mixed depths: slot 0 idle, slot 1 ending on a split boundary (the
    later ranks read nothing), slot 2 mid-window, slot 3 the whole window;
    the trash block (block 0) is NaN."""
    rng = np.random.RandomState(seed)
    nb = b * mb + 1
    w = mb * bs
    per = pa.attn_splits(mb)[1]
    q = torch.from_numpy(rng.standard_normal((b, c, kh * g, dh))
                         .astype(np.float32)).to(dev)
    kp = torch.from_numpy(rng.standard_normal((nb, bs, kh, dh))
                          .astype(np.float32)).to(dev, dtype)
    vp = torch.from_numpy(rng.standard_normal((nb, bs, kh, dh))
                          .astype(np.float32)).to(dev, dtype)
    kp[0] = float("nan")
    vp[0] = float("nan")
    lens = torch.tensor([0, max(0, per * bs - c), min(w // 2 + 3, w - c),
                         w - c], dtype=torch.int32, device=dev)
    kvl = lens + torch.tensor([0, c, c, c], dtype=torch.int32, device=dev)
    tables = torch.from_numpy(rng.permutation(np.arange(1, nb))
                              .astype(np.int32).reshape(b, mb)).to(dev)
    return q, kp, vp, tables, lens, kvl


def _same_bits(a, b):
    """Equal bit for bit (NaN included)."""
    ints = {2: torch.int16, 4: torch.int32}
    return a.dtype == b.dtype and torch.equal(
        a.view(ints[a.element_size()]), b.view(ints[b.element_size()]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("mb", [5, 16, 17])
@pytest.mark.parametrize("c", [1, 5, 16])
def test_b3_bit_exact_vs_plain(c, mb, bs, dh, dtype):
    dev = gpu_device()
    case = _attn_case(7, c, dtype, dev, dh=dh, bs=bs, mb=mb)
    before = pa.paged_attn_call.launches
    out = pa.paged_attn_call(*case)
    ref = pa.paged_attn_plain(*case)
    assert pa.paged_attn_call.launches == before + 1
    assert torch.isfinite(out).all()
    assert torch.equal(out, ref)
    assert (out[0] == 0).all()
    # q read as bfloat16, the output written as bfloat16
    q16 = case[0].bfloat16()
    out16 = pa.paged_attn_call(q16, *case[1:], out_dtype=torch.bfloat16)
    ref16 = pa.paged_attn_plain(q16, *case[1:])
    assert out16.dtype == torch.bfloat16
    assert _same_bits(out16, ref16.to(torch.bfloat16))


def _decode_writes(case, dtype, dev):
    """New K/V rows (pool dtype) and the flat write targets of a C = 1
    `_attn_case`: slot s writes at its position lens[s] (slot 0 idle:
    flat 0)."""
    q, kp, _, tables, lens, _ = case
    b = q.shape[0]
    _, bs, kh, dh = kp.shape
    rng = np.random.RandomState(b * dh + bs)
    nk = torch.from_numpy(rng.standard_normal((b, 1, kh, dh))
                          .astype(np.float32)).to(dev, dtype)
    nv = torch.from_numpy(rng.standard_normal((b, 1, kh, dh))
                          .astype(np.float32)).to(dev, dtype)
    col = (lens // bs).long()
    flat = (tables.gather(1, col[:, None])[:, 0] * bs + lens % bs).int()
    flat[0] = 0
    return nk, nv, flat


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("mb", [5, 16, 17])
def test_b3_b4_decode_launch_bit_exact_vs_plain(mb, bs, dh, dtype):
    """The fused decode launch against fused_write_plain + paged_attn_plain:
    slot 1 writes at offset bs - 1 of rank 0's last column, slots 2 and 3
    into blocks of ranks > 0; slot 0 is idle (flat 0); the trash block is
    NaN. Outputs and both pools bit-exact, at f32 and at bf16 q/output."""
    dev = gpu_device()
    case = _attn_case(8, 1, dtype, dev, dh=dh, bs=bs, mb=mb)
    q, kp, vp, tables, lens, kvl = case
    nk, nv, flat = _decode_writes(case, dtype, dev)
    per = pa.attn_splits(mb)[1]
    assert (lens[2:] // bs // per > 0).all()     # write blocks of ranks > 0
    for qx, out_dtype in ((q, torch.float32),
                          (q.bfloat16(), torch.bfloat16)):
        k2, v2, k3, v3 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        before = pa.decode_write_attend_call.launches
        out = pa.decode_write_attend_call(qx, k2, v2, nk, nv, flat, tables,
                                          lens, kvl, out_dtype=out_dtype)
        ref = pa.decode_write_attend_plain(qx, k3, v3, nk, nv, flat, tables,
                                           lens, kvl).to(out_dtype)
        assert pa.decode_write_attend_call.launches == before + 1
        assert torch.isfinite(out).all() and (out[0] == 0).all()
        assert _same_bits(out, ref)
        assert _same_bits(k2, k3) and _same_bits(v2, v3)
        assert not _same_bits(k2, kp)               # the rows were written
        assert _same_bits(k2[0], kp[0])             # flat 0: no write


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b4_bit_exact_vs_plain(dtype):
    """B4 inside the decode launch: three writes, one invalid lane, new
    rows and tables given as the caller holds them (int64 indices)."""
    dev = gpu_device()
    g = torch.Generator(device="cpu").manual_seed(8)
    kp = torch.randn(9, 16, 8, 128, generator=g).to(dev, dtype)
    vp = torch.randn(9, 16, 8, 128, generator=g).to(dev, dtype)
    nk = torch.randn(4, 1, 8, 128, generator=g).to(dev, dtype)
    nv = torch.randn(4, 1, 8, 128, generator=g).to(dev, dtype)
    q = torch.randn(4, 1, 16, 128, generator=g).to(dev)
    flat = torch.tensor([[17], [0], [40], [143]], device=dev)
    # each slot's table maps its write block at its position
    tables = torch.tensor([[1, 0], [0, 0], [2, 0], [7, 8]], device=dev)
    lens = torch.tensor([1, 0, 8, 31], device=dev)
    kvl = lens + torch.tensor([1, 0, 1, 1], device=dev)
    k2, v2, k3, v3 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    out = pa.decode_write_attend_call(q, k2, v2, nk, nv, flat, tables, lens,
                                      kvl)
    ref = pa.decode_write_attend_plain(q, k3, v3, nk, nv, flat, tables, lens,
                                       kvl)
    assert torch.equal(k2, k3) and torch.equal(v2, v3)
    assert torch.equal(k2[0], kp[0])       # flat 0: no write
    assert torch.equal(out, ref)


# Head dims and block sizes past B3's fast case (dh in {32, 64, 128, 256},
# bs <= 32): rows of bf16 dh 20 are 40 bytes (8-byte copies), of dh 21 42
# bytes in bf16 (2-byte copies) and 84 in f32 (4-byte copies); dh 56 is
# deepseek-v3's d_model / n_heads (7168 / 128; its MLA attention never
# reaches B3: q/k head dim 192, V 128), dh 80 stablelm-3b's; bs > 32 is
# scored in pieces of 32 tokens.
C1_SHAPES = [(16, 16), (20, 16), (21, 8), (56, 16), (80, 16), (96, 8),
             (128, 48), (128, 64), (80, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,bs", C1_SHAPES)
@pytest.mark.parametrize("c", [1, 5, 16])
def test_b3_any_head_dim_and_block_size_bit_exact(c, dh, bs, dtype):
    dev = gpu_device()
    case = _attn_case(10, c, dtype, dev, dh=dh, bs=bs, mb=16)
    out = pa.paged_attn_call(*case)
    ref = pa.paged_attn_plain(*case)
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    assert torch.equal(out, ref)
    q16 = case[0].bfloat16()
    out16 = pa.paged_attn_call(q16, *case[1:], out_dtype=torch.bfloat16)
    assert _same_bits(out16, pa.paged_attn_plain(q16, *case[1:])
                      .to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,bs", C1_SHAPES)
@pytest.mark.parametrize("mb", [5, 16])
def test_b3_b4_decode_launch_any_head_dim_and_block_size(mb, dh, bs, dtype):
    dev = gpu_device()
    case = _attn_case(11, 1, dtype, dev, dh=dh, bs=bs, mb=mb)
    q, kp, vp, tables, lens, kvl = case
    nk, nv, flat = _decode_writes(case, dtype, dev)
    k2, v2, k3, v3 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    out = pa.decode_write_attend_call(q, k2, v2, nk, nv, flat, tables, lens,
                                      kvl)
    ref = pa.decode_write_attend_plain(q, k3, v3, nk, nv, flat, tables, lens,
                                       kvl)
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    assert _same_bits(out, ref)
    assert _same_bits(k2, k3) and _same_bits(v2, v3)
    assert not _same_bits(k2, kp) and _same_bits(k2[0], kp[0])


def test_b3_rejects_what_the_reference_rejects():
    dev = gpu_device()
    q, kp, vp, tables, lens, kvl = _attn_case(12, 1, torch.float32, dev,
                                              dh=80, bs=16, mb=5)
    with pytest.raises(ValueError, match="shape mismatch"):   # KH ∤ H
        pa.paged_attn_call(q[:, :, :15], kp, vp, tables, lens, kvl)
    wide = torch.zeros(*kp.shape[:3], 257, device=dev)
    with pytest.raises(ValueError, match="1 <= dh <= 256"):
        pa.paged_attn_call(torch.zeros(*q.shape[:3], 257, device=dev), wide,
                           wide, tables, lens, kvl)


def test_verify_step_kernels_bit_exact_vs_plain():
    """A speculative verify step (C = spec_k + 1 = 5, all positions'
    logits) at decode depth on the smoke model under --cim bp-prequant:
    the kernels (B1, B3 after paged_write) against their plain versions,
    logits and pools identical."""
    import dataclasses
    from repro_torch.configs.registry import SMOKES
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.models import quantize, registry, transformer
    dev = gpu_device()
    cfg = SMOKES["internlm2-1.8b"].replace(cim=CIMConfig(enabled=True))
    params = quantize.quantize_params(
        registry.init_params(cfg, seed=0, device=dev), cfg, packed=True)
    rng = np.random.RandomState(13)
    tables = torch.arange(1, 17, dtype=torch.int32, device=dev).reshape(4, 4)
    runs = []
    for step_cfg in (cfg, cfg.replace(attn_backend="plain", cim=dataclasses
                                      .replace(cfg.cim, backend="plain"))):
        cache = transformer.init_paged_cache(step_cfg, 17, 16, device=dev)
        toks = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 16))).to(dev)
        lens = torch.zeros(4, dtype=torch.int32, device=dev)
        valid = torch.tensor([16, 16, 9, 0], dtype=torch.int32, device=dev)
        _, cache = transformer.paged_step(params, toks, cache, tables, lens,
                                          valid, step_cfg)
        draft = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 5))).to(dev)
        logits, cache = transformer.paged_step(
            params, draft, cache, tables, valid,
            torch.tensor([5, 3, 1, 0], dtype=torch.int32, device=dev),
            step_cfg, all_logits=True)
        runs.append((logits, cache["layers"]))
        rng = np.random.RandomState(13)
    (lk, pk), (lp, pp) = runs
    assert lk.shape == (4, 5, cfg.vocab) and torch.isfinite(lk[:3]).all()
    assert torch.equal(lk[:3], lp[:3])
    assert _same_bits(pk["k"][:, 1:], pp["k"][:, 1:])
    assert _same_bits(pk["v"][:, 1:], pp["v"][:, 1:])


def test_decode_launch_rejects_bad_operands():
    dev = gpu_device()
    case = _attn_case(9, 1, torch.bfloat16, dev, dh=128, bs=16, mb=16)
    q, kp, vp, tables, lens, kvl = case
    nk, nv, flat = _decode_writes(case, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="bfloat16"):     # pool dtype
        pa.decode_write_attend_call(q, kp, vp, nk.float(), nv, flat, tables,
                                    lens, kvl)
    strided = nk.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        pa.decode_write_attend_call(q, kp, vp, strided, nv, flat, tables,
                                    lens, kvl)
    q16 = torch.cat([q, q], 1)
    with pytest.raises(ValueError, match="C = 1"):
        pa.decode_write_attend_call(q16, kp, vp, nk, nv, flat, tables, lens,
                                    kvl)


def _telemetry_serve(cfg, dev):
    """The smoke model served with telemetry on (a unit-step fake clock),
    requests 0 and 1 at n_samples 2, trie_watermark 0.5 over a 24-block
    pool: (streams, ServerMetrics.to_dict(), event kinds in order)."""
    from repro_torch.models import registry
    from repro_torch.runtime.server import Request, Server, ServingConfig
    from repro_torch.runtime.telemetry import Telemetry
    ticks = iter(range(1, 1 << 30))
    params = registry.init_params(cfg, seed=0, device=dev)
    srv = Server(params, cfg, ServingConfig(
        paged=True, n_slots=4, max_len=64, block_size=8, num_blocks=24,
        prefill_chunk=8, prequant=True, attn=cfg.attn_backend,
        trie_watermark=0.5), telemetry=Telemetry(
            clock=lambda: float(next(ticks))), device=dev)
    rng = np.random.RandomState(17)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab, size=int(n)).tolist(),
                    max_new_tokens=6, n_samples=2 if i < 2 else 1)
            for i, n in enumerate(rng.randint(17, 41, size=6))]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    streams = [x.output for r in reqs for x in (r, *r.samples)]
    return streams, srv.metrics.to_dict(), [e.kind for e in
                                            srv.telemetry.events]


def test_telemetry_serve_kernels_match_plain():
    """Telemetry on, parallel samples and the trie sweep: the kernel
    backends (B1, B3, the B3+B4 decode launch) and their plain versions
    serve identical streams, metrics and event kinds."""
    import dataclasses
    from repro_torch.configs.registry import SMOKES
    from repro_torch.core.cim_matmul import CIMConfig
    dev = gpu_device()
    cfg = SMOKES["internlm2-1.8b"].replace(cim=CIMConfig(enabled=True),
                                           attn_backend="kernel")
    kern = _telemetry_serve(cfg, dev)
    plain = _telemetry_serve(cfg.replace(
        attn_backend="plain", cim=dataclasses.replace(cfg.cim,
                                                      backend="plain")), dev)
    assert kern == plain
    streams, metrics, kinds = kern
    assert len(streams) == 8 and all(len(s) == 6 for s in streams)
    assert metrics["cow_forks"] > 0 and metrics["trie_sweep_freed"] > 0
    assert {"cow_fork", "first_token", "decode", "retire"} <= set(kinds)


def _slot_serve(cfg, dev):
    """The slot engine (`ServingConfig()`), nibble-packed prequant, 2 slots:
    four requests of 5-40 prompt tokens, the later ones admitted mid-flight
    at other depths; (streams, ServerMetrics.summary() without wall_s)."""
    from repro_torch.models import registry
    from repro_torch.runtime.server import Request, Server, ServingConfig
    params = registry.init_params(cfg, seed=0, device=dev)
    srv = Server(params, cfg, ServingConfig(n_slots=2, max_len=64,
                                            prequant=True), device=dev)
    rng = np.random.RandomState(18)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab, size=int(n)).tolist(),
                    max_new_tokens=5) for n in (5, 40, 17, 9)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    m = srv.metrics.summary()
    del m["wall_s"], m["decode_tok_s"], m["prefill_tok_s"]
    return [r.output for r in reqs], m


def test_slot_engine_kernels_match_plain():
    """The slot engine's per-request prefill (B1 at M = the prompt length)
    and decode step (M = n_slots, idle lanes included) with the kernels
    and with their plain versions: identical logits, caches, streams and
    metrics."""
    import dataclasses
    from repro_torch.configs.registry import SMOKES
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.models import registry, transformer
    from repro_torch.models.quantize import quantize_params
    from repro_torch.runtime.server import _splice
    dev = gpu_device()
    cfg = SMOKES["internlm2-1.8b"].replace(cim=CIMConfig(enabled=True))
    plain = cfg.replace(cim=dataclasses.replace(cfg.cim, backend="plain"))
    params = quantize_params(registry.init_params(cfg, seed=0, device=dev),
                             cfg)
    rng = np.random.RandomState(19)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (1, 37))).to(dev)
    nxt = torch.from_numpy(rng.randint(0, cfg.vocab, (3, 1))).to(dev)
    outs = []
    for c in (cfg, plain):
        l1, rc = transformer.prefill(params, {"tokens": toks}, c,
                                     max_len=64)
        cache = _splice(transformer.init_cache(c, 3, 64, device=dev), rc, 2)
        l2, cache = transformer.decode_step(params, nxt, cache, c)
        outs.append((l1, l2, cache["layers"]["k"], cache["layers"]["v"]))
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    before = cim_mvm.cim_mvm_grouped_packed.launches
    kern = _slot_serve(cfg, dev)
    assert cim_mvm.cim_mvm_grouped_packed.launches > before
    assert kern == _slot_serve(plain, dev)
    assert all(len(s) == 5 for s in kern[0])


LADDER = (32, 45, 64, 91, 128, 181, 256)   # core.precision's rungs < 362


@pytest.mark.parametrize("levels", LADDER)
@pytest.mark.parametrize("m,k,n", [(3, 301, 70), (4, 2048, 1024),
                                   (64, 2047, 160)])
def test_mvm_kernels_bit_exact_on_the_adc_ladder(m, k, n, levels):
    """B1/B2 (IDEAL) and B5/B6 (NOISY and FULL) at ADC levels other than
    362: lsb, inv_lsb, inv_lsb / L and code_max all change with L."""
    dev = gpu_device()
    x = _codes(m + levels, (m, k)).to(dev)
    w = _codes(n + levels, (k, n)).to(dev)
    wp = ops.pack_codes(w).contiguous()
    kw = dict(KW, levels=levels)
    assert torch.equal(cim_mvm.cim_mvm_grouped(x, w, **kw),
                       cim_mvm.cim_mvm_grouped_plain(x, w, **kw))
    assert torch.equal(cim_mvm.cim_mvm_grouped_packed(x, wp, **kw),
                       cim_mvm.cim_mvm_grouped_packed_plain(x, wp, **kw))
    s = torch.tensor([7], dtype=torch.int32, device=dev)
    for nkw in (dict(NOISY, levels=levels), dict(FULL, levels=levels)):
        y5 = cim_mvm.cim_mvm_grouped_noisy(x, w, s, inl_seed=3, **nkw)
        assert torch.equal(y5, cim_mvm.cim_mvm_grouped_noisy_plain(
            x, w, s, inl_seed=3, **nkw))
        assert torch.equal(cim_mvm.cim_mvm_grouped_noisy_packed(
            x, wp, s, inl_seed=3, **nkw), y5)


def _mixed_manifest_cim(cim):
    """The committed manifest with wv on WBS, w_up per-channel and wo at
    45 ADC levels, applied to `cim`."""
    import json
    import os
    from repro_torch.analysis import precision_search as ps
    path = os.path.join(os.path.dirname(__file__), "..",
                        "precision_manifest.json")
    with open(path) as f:
        man = json.load(f)
    man["sites"]["wv"]["scheme"] = "wbs"
    man["sites"]["w_up"]["per_channel"] = True
    man["sites"]["wo"]["adc_levels"] = 45
    return ps.apply_manifest(cim, man)


@pytest.mark.parametrize("mixed", [False, True])
def test_manifest_step_kernels_bit_exact_vs_plain(mixed):
    """A paged prefill (C = 16) and decode step of the smoke model under
    a precision manifest, kernels (B1 at the site levels, B3, the decode
    launch; the mixed manifest's WBS site on einsum) against their plain
    versions: identical logits and pools."""
    import dataclasses
    import json
    import os
    from repro_torch.analysis import precision_search as ps
    from repro_torch.configs.registry import SMOKES
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.models import quantize, registry, transformer
    dev = gpu_device()
    cfg = SMOKES["internlm2-1.8b"].replace(cim=CIMConfig(enabled=True))
    if mixed:
        cim = _mixed_manifest_cim(cfg.cim)
    else:
        with open(os.path.join(os.path.dirname(__file__), "..",
                               "precision_manifest.json")) as f:
            cim = ps.apply_manifest(cfg.cim, json.load(f))
    cfg = cfg.replace(cim=cim)
    params = quantize.quantize_params(
        registry.init_params(cfg, seed=0, device=dev), cfg, packed=True)
    from repro_torch.runtime.telemetry import KERNEL_COUNTERS
    tables = torch.arange(1, 17, dtype=torch.int32, device=dev).reshape(4, 4)
    runs = []
    for step_cfg in (cfg, cfg.replace(attn_backend="plain", cim=dataclasses
                                      .replace(cfg.cim, backend="plain"))):
        KERNEL_COUNTERS.reset()
        rng = np.random.RandomState(21)
        cache = transformer.init_paged_cache(step_cfg, 17, 16, device=dev)
        toks = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 16))).to(dev)
        lens = torch.zeros(4, dtype=torch.int32, device=dev)
        valid = torch.tensor([16, 16, 9, 0], dtype=torch.int32, device=dev)
        l1, cache = transformer.paged_step(params, toks, cache, tables, lens,
                                           valid, step_cfg)
        nxt = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 1))).to(dev)
        l2, cache = transformer.paged_step(
            params, nxt, cache, tables, valid,
            torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=dev),
            step_cfg)
        runs.append((l1, l2, cache["layers"]))
        if step_cfg is cfg:     # the WBS site has no kernel: einsum
            einsum = KERNEL_COUNTERS.snapshot()["backend_dispatch"].get(
                "einsum", 0)
            assert einsum == (2 * cfg.n_layers if mixed else 0)
    (a1, a2, pk), (b1, b2, pp) = runs
    assert torch.isfinite(a1[:3]).all() and torch.isfinite(a2[:3]).all()
    assert torch.equal(a1[:3], b1[:3]) and torch.equal(a2[:3], b2[:3])
    assert _same_bits(pk["k"][:, 1:], pp["k"][:, 1:])
    assert _same_bits(pk["v"][:, 1:], pp["v"][:, 1:])


def test_static_grid_lane_decoupled_on_the_card():
    """Under a calibrated static grid a probe's greedy stream is the same
    served alone and beside companions (paged engine, the kernels)."""
    from repro_torch.analysis.calibrate import calibrate_act_scale
    from repro_torch.configs.registry import SMOKES
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.models import registry
    from repro_torch.runtime.server import Request, Server, ServingConfig
    dev = gpu_device()
    cfg = SMOKES["internlm2-1.8b"].replace(cim=CIMConfig(enabled=True))
    params = registry.init_params(cfg, seed=0, device=dev)
    cal = calibrate_act_scale(params, np.random.RandomState(7).randint(
        0, cfg.vocab, size=(2, 16)), cfg)
    outs = []
    for companions in ([], [[11, 3, 8], [1, 2, 3, 4, 5, 6]]):
        srv = Server(params, cfg, ServingConfig(
            n_slots=3, max_len=64, paged=True, prequant=True, block_size=8,
            prefill_chunk=4, act_scale=cal["scale"],
            act_zero_point=cal["zero_point"]), device=dev)
        probe = Request(prompt=[5, 9, 2, 7, 4], max_new_tokens=6)
        srv.submit(probe)
        for p in companions:
            srv.submit(Request(prompt=p, max_new_tokens=6))
        srv.run_until_drained()
        outs.append(probe.output)
    assert outs[0] == outs[1] and len(outs[0]) == 6


# ---------------------------------------------------------------------------
# training (ROADMAP A10a): gradients through the kernels, train steps
# ---------------------------------------------------------------------------
def _cim(level, backend="auto"):
    import dataclasses
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.core.macro import SimLevel
    cim = CIMConfig(enabled=True, backend=backend,
                    noise_seed=None if level == "ideal" else 0)
    return dataclasses.replace(cim, macro=dataclasses.replace(
        cim.macro, sim_level=SimLevel(level)))


@pytest.mark.parametrize("level", ["ideal", "noisy", "full"])
@pytest.mark.parametrize("stored", [False, True])
def test_cim_matmul_gradient_kernels_equal_plain(level, stored):
    """cim_matmul (float weights: B2 / B5) and cim_matmul_prequant
    (nibble-packed codes: B1 / B6) under autograd: the output keeps its
    grad_fn, the forward and the gradients (x's, and w's from float
    weights) are identical with the kernels and with their plain versions,
    one launch per forward and none in the backward."""
    cm = importlib.import_module("repro_torch.core.cim_matmul")
    from repro_torch.kernels import build
    dev = gpu_device()
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(24, 600).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(600, 136) * 0.05).astype(
        np.float32)).to(dev)
    c = torch.from_numpy(rng.randn(24, 136).astype(np.float32)).to(dev)
    outs = []
    for backend in ("auto", "plain"):
        cim = _cim(level, backend)
        x1 = x.clone().requires_grad_()
        w1 = w.clone().requires_grad_()
        build.reset_launch_counts()
        if stored:
            q, s = cm.quantize_weight_offline(w, cim)
            y = cm.cim_matmul_prequant(x1, ops.pack_codes(q), s, cim)
        else:
            y = cm.cim_matmul(x1, w1, cim)
        assert y.grad_fn is not None
        n_fwd = sum(build.launch_counts().values())
        (y * c).sum().backward()
        torch.cuda.synchronize()
        assert sum(build.launch_counts().values()) == n_fwd
        assert n_fwd == (1 if backend == "auto" else 0)
        outs.append((y.detach(), x1.grad, w1.grad))
    (yk, gxk, gwk), (yp, gxp, gwp) = outs
    assert torch.equal(yk, yp) and torch.equal(gxk, gxp)
    assert (gwk is None and gwp is None) if stored else torch.equal(gwk, gwp)


def test_cim_matmul_ste_kernel_equals_plain():
    cm = importlib.import_module("repro_torch.core.cim_matmul")
    dev = gpu_device()
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.randn(40, 2048).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(2048, 1024) * 0.02).astype(
        np.float32)).to(dev)
    outs = []
    for backend in ("auto", "plain"):
        x1 = x.clone().requires_grad_()
        w1 = w.clone().requires_grad_()
        y = cm.cim_matmul_ste(x1, w1, _cim("ideal", backend))
        y.square().sum().backward()
        outs.append((y.detach(), x1.grad, w1.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _smoke_train(cim):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import SMOKES
    from repro_torch.data.tokens import SyntheticLMDataset
    from repro_torch.models import registry
    from repro_torch.runtime.trainer import make_train_step
    dev = gpu_device()
    cfg = SMOKES["internlm2-1.8b"].replace(cim=cim)
    params = registry.init_params(cfg, seed=0, device=dev)
    step, opt = make_train_step(cfg, TrainConfig(steps=10, lr=1e-3))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             SyntheticLMDataset(cfg.vocab, 32, 4, seed=0).batch(0).items()}
    return step, {"params": params, "opt": opt.init(params)}, batch


def _same_tree(a, b):
    from repro_torch.optim.optimizers import tree_leaves
    return all(torch.equal(x.view(torch.int16), y.view(torch.int16))
               if x.element_size() == 2 else torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("level", ["ideal", "noisy"])
def test_train_step_kernels_bit_exact_vs_plain(level):
    """Two steps of the smoke internlm2 (bf16, --cim bp; NOISY at
    noise_seed 0) with the kernels (B2 / B5 under cim_matmul_ste) and with
    their plain versions: losses, grad norms and the whole state (params,
    AdamW m / v) identical; 2 · 7 · 2 + 1 = 29 launches a step (per-layer
    remat re-runs each layer's 7 MVMs)."""
    from repro_torch.kernels import build
    kname = "cim_mvm_grouped" if level == "ideal" else "cim_mvm_grouped_noisy"
    runs = []
    for backend in ("auto", "plain"):
        step, state, batch = _smoke_train(_cim(level, backend))
        metrics = []
        for _ in range(2):
            build.reset_launch_counts()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            assert build.launch_counts()[kname] == (
                29 if backend == "auto" else 0)
            metrics.append(m)
        runs.append((state, metrics))
    (sk, mk), (sp, mp) = runs
    for a, b in zip(mk, mp):
        assert torch.equal(a["loss"], b["loss"])
        assert torch.equal(a["grad_norm"], b["grad_norm"])
    assert _same_tree(sk, sp)


def test_train_steps_are_deterministic():
    """The same two steps twice from one state give the same bits: the
    embedding gather's and the CE gather's backward add without atomics."""
    step, state0, batch = _smoke_train(_cim("ideal"))
    finals = []
    for _ in range(2):
        state = state0
        for _ in range(2):
            state, _ = step(state, batch)
        finals.append(state)
    assert _same_tree(*finals)


def test_row_gather_backward_deterministic_and_ordered():
    """The embedding backward on the card equals the CPU's (tokens added in
    ascending position order) bit for bit, with many repeated tokens."""
    from repro_torch.models.common import _RowGather
    dev = gpu_device()
    rng = np.random.RandomState(13)
    table = torch.from_numpy(rng.randn(50, 64).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 12, (8, 96)))
    g = torch.from_numpy(rng.randn(8, 96, 64).astype(np.float32))
    grads = []
    for d in ("cpu", dev, dev):
        t = table.detach().to(d).requires_grad_()
        _RowGather.apply(t, idx.to(d)).backward(g.to(d))
        grads.append(t.grad.cpu())
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[1], grads[2])


# ---------------------------------------------------------------------------
# training, the A10b legs: the expert STE through B2e, every arch's step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_ste_kernel_equals_plain(dtype):
    """cim_matmul_ste on an expert stack (x [E, C, K], w [E, K, M] in f32
    or bf16): forward and per-expert gradients identical with B2e and with
    its plain version; one launch forward, none in the backward."""
    cm = importlib.import_module("repro_torch.core.cim_matmul")
    from repro_torch.kernels import build
    dev = gpu_device()
    rng = np.random.RandomState(14)
    x = torch.from_numpy(rng.randn(16, 40, 300).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(16, 300, 88) * 0.05).astype(
        np.float32)).to(dev, dtype)
    c = torch.from_numpy(rng.randn(16, 40, 88).astype(np.float32)).to(dev)
    outs = []
    for backend in ("auto", "plain"):
        x1 = x.clone().requires_grad_()
        w1 = w.clone().requires_grad_()
        build.reset_launch_counts()
        y = cm.cim_matmul_ste(x1, w1, _cim("ideal", backend))
        (y * c).sum().backward()
        torch.cuda.synchronize()
        assert build.launch_counts()["cim_mvm_grouped_experts"] == (
            1 if backend == "auto" else 0)
        assert w1.grad.dtype == dtype
        outs.append((y.detach(), x1.grad, w1.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_moe_dispatch_backward_equals_cpu():
    """The MoE dispatch's expand and the capacity buffer's gather: their
    backward on the card equals the CPU's bit for bit, twice."""
    from repro_torch.models import moe
    dev = gpu_device()
    rng = np.random.RandomState(15)
    x2 = torch.from_numpy(rng.randn(64, 32).astype(np.float32))
    g = torch.from_numpy(rng.randn(256, 32).astype(np.float32))
    table = torch.from_numpy(rng.randn(41, 32).astype(np.float32))
    slot = torch.from_numpy(np.r_[rng.permutation(40)[:30], [40] * 10])
    gs = torch.from_numpy(rng.randn(40, 32).astype(np.float32))
    out = []
    for d in ("cpu", dev, dev):
        a = x2.to(d).clone().requires_grad_()
        moe._RepeatRows.apply(a, 4).backward(g.to(d))
        t = table.to(d).clone().requires_grad_()
        moe._SlotGather.apply(t, slot.to(d)).backward(gs.to(d))
        out.append((a.grad.cpu(), t.grad.cpu()))
    for later in out[1:]:
        assert all(torch.equal(p, q) for p, q in zip(out[0], later))


A10B_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v3-671b", "rwkv6-7b",
              "zamba2-2.7b", "whisper-large-v3", "internvl2-26b")


def _smoke_leg(arch, cim, seq=32):
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import SMOKES
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models import registry
    from repro_torch.runtime.trainer import make_train_step
    dev = gpu_device()
    cfg = SMOKES[arch].replace(cim=cim)
    params = registry.init_params(cfg, seed=0, device=dev, max_seq=seq + 8)
    step, opt = make_train_step(cfg, TrainConfig(steps=10, lr=1e-3))
    batch = synthetic_batch(cfg, ShapeConfig("t", seq + cfg.n_image_tokens,
                                             2, "train"), device=dev)
    return step, {"params": params, "opt": opt.init(params)}, batch


@pytest.mark.parametrize("arch", A10B_ARCHS)
def test_a10b_train_step_kernels_bit_exact_vs_plain(arch):
    """One step of each A10b smoke arch (bf16, --cim bp) with the kernels
    and with their plain versions: loss, grad norm and the whole state
    identical; the MoE archs launch B2e 3 times a MoE layer forward, twice
    under per-layer remat."""
    from repro_torch.configs.registry import SMOKES
    from repro_torch.kernels import build
    runs = []
    for backend in ("auto", "plain"):
        step, state, batch = _smoke_leg(arch, _cim("ideal", backend))
        build.reset_launch_counts()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        runs.append((state, m, build.launch_counts()))
    (sk, mk, ck), (sp, mp, cp) = runs
    cfg = SMOKES[arch]
    n_moe = cfg.n_layers - cfg.moe.first_dense if cfg.moe else 0
    assert ck["cim_mvm_grouped_experts"] == 3 * 2 * n_moe
    assert ck["cim_mvm_grouped"] > 0 and not any(cp.values())
    assert torch.equal(mk["loss"], mp["loss"])
    assert torch.equal(mk["grad_norm"], mp["grad_norm"])
    assert _same_tree(sk, sp)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_a10b_train_steps_are_deterministic(arch):
    """Two steps twice from one state give the same bits (the MoE
    dispatch and combine add without atomics)."""
    step, state0, batch = _smoke_leg(arch, _cim("ideal"))
    finals = []
    for _ in range(2):
        state = state0
        for _ in range(2):
            state, _ = step(state, batch)
        finals.append(state)
    assert _same_tree(*finals)


# the figures' B2 shapes (BP at IDEAL from float weights): Fig. 10's and
# Fig. 1b's classifier layers (x [1024, 64] x [64, 144], a single partial
# group, and [1024, 144] x [144, 16]) and quickstart's x [8, 288] x [288, 16]
FIG_LADDER = (32, 64, 128, 256, 362, 512, 1024)
FIG_SHAPES = [(1024, 64, 144), (1024, 144, 16), (8, 288, 16)]


@pytest.mark.parametrize("levels", FIG_LADDER)
@pytest.mark.parametrize("m,k,n", FIG_SHAPES)
def test_b2_bit_exact_at_the_figure_shapes(m, k, n, levels):
    dev = gpu_device()
    x = _codes(m + levels, (m, k)).to(dev)
    w = _codes(n + levels, (k, n)).to(dev)
    kw = dict(KW, levels=levels)
    assert torch.equal(cim_mvm.cim_mvm_grouped(x, w, **kw),
                       cim_mvm.cim_mvm_grouped_plain(x, w, **kw))


def test_figures_fig10_on_the_card(capsys):
    """Fig. 10 through figures.run on the card: its 7 rows, one B2 launch
    per layer and ladder rung (14), and each rung's accuracy equal to the
    one its plain version gives on the same weights."""
    import dataclasses
    from repro_torch.core import PROTOTYPE, CIMConfig, cim_matmul
    from repro_torch.figures import common, run
    from repro_torch.kernels import build
    dev = gpu_device()
    build.reset_launch_counts()
    run.main(["--only", "fig10"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(",")[0] for ln in lines[1:]] == [
        f"fig10_adc{b}b" for b in ("5", "6", "7", "8", "8.5", "9", "10")]
    assert all("ERROR" not in ln for ln in lines)
    counts = build.launch_counts()
    assert counts["cim_mvm_grouped"] == 14
    assert sum(counts.values()) == 14
    task = common.make_task(device=dev)
    params = common.train_mlp(task)
    for levels in (32, 362, 1024):
        macro = dataclasses.replace(PROTOTYPE, adc_levels=levels)
        outs = []
        for backend in ("auto", "plain"):
            cfg = CIMConfig(enabled=True, macro=macro, backend=backend)
            h = torch.relu(cim_matmul(task.x_test, params["w1"], cfg))
            outs.append(cim_matmul(h, params["w2"], cfg))
        assert torch.equal(outs[0], outs[1]), levels
