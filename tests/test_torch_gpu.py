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
routed experts at --cim bp / bp-noisy) on both of their bodies (the
tensor-core one for codes of at most 8 bits in groups of a multiple of
four rows, up to 96 rows and in a CUDA-graph replay; the dense kernel's
for wider codes and other depths; the launcher's `used` report says which
ran), and the smoke deepseek-v3's slot
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
with its plain version. The tuning cache's launch knobs: every cluster
size and column-warp count bit-exact against the default launch and the
plain version for B1, B2, B5, B6 and their expert-batched entries (a
knob the launcher cannot take clamped and counted), B3 and the decode
launch at every split S from 1 to 8 against their plain versions at that
S; a 1-rank nccl mesh's sharded MVMs bit-identical to no mesh, and the
Trainer with its state placed on that mesh bit-identical to no mesh's
(two smoke internlm2 steps at --cim bp, 29 B2 launches each). Inputs
come from numpy seeds. This file needs no JAX.
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
# (the one-block-per-32-columns body); then one expert, the expert-parallel
# slices (8 / 16 / 32 experts: the groups split over warps), two row tiles
# (M 9 and 16), N 1400 (no multiple of the 64-column tile) and 67 experts
# (steps that do not divide the persistent grid)
EXPERT_SHAPES = [(64, 8, 2048, 1408, 144), (64, 8, 1408, 2048, 144),
                 (16, 8, 128, 64, 144), (16, 8, 64, 128, 144),
                 (5, 3, 301, 70, 144), (3, 4, 2047, 1024, 144),
                 (4, 64, 2048, 4096, 144), (6, 8, 700, 96, 146),
                 (1, 8, 2048, 1408, 144),
                 (8, 8, 2048, 1408, 144), (8, 8, 1408, 2048, 144),
                 (16, 8, 2048, 1408, 144), (16, 8, 1408, 2048, 144),
                 (32, 8, 2048, 1408, 144), (32, 8, 1408, 2048, 144),
                 (4, 9, 2048, 1408, 144), (4, 16, 1408, 2048, 144),
                 (8, 8, 2048, 1400, 144), (67, 8, 2048, 1408, 144)]


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


def test_experts_report_the_launch_they_made():
    """The expert-batched packed entries take no launch knob: `used` reads
    {0, 0} whatever cluster and column warps are asked for, and the
    wrapper counts the clamp; B1's 2-D entry reports the knobs it
    launched."""
    from repro_torch.kernels import build
    from repro_torch.runtime.telemetry import KERNEL_COUNTERS
    dev = gpu_device()
    x = _codes(3, (4, 8, 2048)).to(dev)
    wp = ops.pack_codes(_codes(4, (4, 2048, 1408)).to(dev)).contiguous()
    lsb, inv_lsb = cim_mvm.adc_constants(362, 1.0, 32400.0)
    lib = build.load("cim_mvm")
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(4, 8, 1408, device=dev)
    knobs = cim_mvm._knob_args(2, 4)
    assert lib.cim_mvm_packed_experts_launch(
        x.data_ptr(), wp.data_ptr(), out.data_ptr(), 4, 8, 1408, 2048, 1024,
        144, inv_lsb, lsb, 361.0, *knobs, stream) == 0
    assert (knobs[2][0], knobs[2][1]) == (0, 0)
    s = torch.tensor([7], dtype=torch.int32, device=dev)
    st = cim_mvm._stochastic_args(inv_lsb, 362, 0.277, 0.0, 0, False)
    knobs = cim_mvm._knob_args(8, 8)
    assert lib.cim_mvm_noisy_packed_experts_launch(
        x.data_ptr(), wp.data_ptr(), out.data_ptr(), 4, 8, 1408, 2048, 1024,
        144, inv_lsb, lsb, 361.0, st[0], s.data_ptr(), st[1], st[2], st[3],
        *knobs, stream) == 0
    assert (knobs[2][0], knobs[2][1]) == (0, 0)
    # B2e / B5e: the tensor-core body takes no knob ({0, 0}); without the
    # codes' width stated the dense kernel's body reports what it launched
    w = _codes(5, (4, 2048, 1408)).to(dev)
    for bits, want in ((4, (0, 0)), (0, (2, 4))):
        knobs = cim_mvm._knob_args(2, 4)
        assert lib.cim_mvm_dense_experts_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), 4, 8, 1408, 2048,
            144, inv_lsb, lsb, 361.0, bits, *knobs, stream) == 0
        assert (knobs[2][0], knobs[2][1]) == want, bits
        knobs = cim_mvm._knob_args(2, 4)
        assert lib.cim_mvm_noisy_dense_experts_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), 4, 8, 1408, 2048,
            144, inv_lsb, lsb, 361.0, st[0], s.data_ptr(), st[1], st[2],
            st[3], bits, *knobs, stream) == 0
        assert (knobs[2][0], knobs[2][1]) == want, bits
    knobs = cim_mvm._knob_args(2, 4)
    out2 = torch.empty(8, 1408, device=dev)
    assert lib.cim_mvm_packed_launch(
        x[0].data_ptr(), wp[0].data_ptr(), out2.data_ptr(), 8, 1408, 2048,
        1024, 144, inv_lsb, lsb, 361.0, *knobs, stream) == 0
    assert (knobs[2][0], knobs[2][1]) == (2, 4)
    torch.cuda.synchronize()
    KERNEL_COUNTERS.reset()
    y = cim_mvm.cim_mvm_grouped_packed_experts(x, wp, **KW, cluster=2,
                                               wcols=4)
    assert KERNEL_COUNTERS.tune_cache["cim_mvm:clamp"] == 1
    KERNEL_COUNTERS.reset()
    assert torch.equal(y, cim_mvm.cim_mvm_grouped_packed_experts(x, wp, **KW))
    y = cim_mvm.cim_mvm_grouped_experts(x, w, **KW, cluster=2, wcols=4,
                                        code_bits=4)
    assert KERNEL_COUNTERS.tune_cache["cim_mvm:clamp"] == 1
    KERNEL_COUNTERS.reset()
    assert torch.equal(y, cim_mvm.cim_mvm_grouped_experts_plain(x, w, **KW))
    assert torch.equal(y, cim_mvm.cim_mvm_grouped_experts(x, w, **KW,
                                                          cluster=2, wcols=4))
    KERNEL_COUNTERS.reset()


def test_experts_report_the_launch_they_made_at_c40():
    """The tensor-core body at 40 rows (one tall tile) takes no knob
    either; the dense kernel's body at 8-row tiles reports its own."""
    from repro_torch.kernels import build
    dev = gpu_device()
    x = _codes(6, (4, 40, 1408)).to(dev)
    w = _codes(7, (4, 1408, 2048)).to(dev)
    lsb, inv_lsb = cim_mvm.adc_constants(362, 1.0, 32400.0)
    lib = build.load("cim_mvm")
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = []
    for bits, want in ((4, (0, 0)), (0, (1, 2))):
        out = torch.empty(4, 40, 2048, device=dev)
        knobs = cim_mvm._knob_args(1, 2)
        assert lib.cim_mvm_dense_experts_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), 4, 40, 2048, 1408,
            144, inv_lsb, lsb, 361.0, bits, *knobs, stream) == 0
        assert (knobs[2][0], knobs[2][1]) == want, bits
        outs.append(out)
    torch.cuda.synchronize()
    plain = cim_mvm.cim_mvm_grouped_experts_plain(x, w, **KW)
    assert torch.equal(outs[0], plain) and torch.equal(outs[1], plain)


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


# (E, M, K, N, n_rows, code bits) of the expert-batched B2 / B5:
# deepseek-v3's expert widths on fewer experts (capacity 8; K 7168 -> N
# 256 and K 2048 -> N 896), the smoke model's, the 4-row tile, an odd K,
# warps side by side (N 4096 at M > 4), N % 4 != 0 (4-byte copies);
# qwen2-moe's widths at its training capacity 40 (one 40-row tile), rows
# across the tile boundaries (9, 16, 33, 41, 64, 96), a ragged N at C 40,
# 8-bit codes (up to 255, the u8 MMA's widest); then the dense kernel's
# body: 9-bit codes, depth 9, and groups staged in passes (n_rows 1)
DENSE_EXPERT_SHAPES = [(16, 8, 7168, 256, 144, 4), (16, 8, 2048, 896, 144, 4),
                       (16, 8, 128, 64, 144, 4), (16, 8, 64, 128, 144, 4),
                       (5, 3, 301, 70, 144, 4), (3, 4, 2047, 1024, 144, 4),
                       (4, 64, 2048, 4096, 144, 4), (4, 8, 1500, 18, 144, 4),
                       (4, 40, 2048, 1408, 144, 4), (4, 40, 1408, 2048, 144, 4),
                       (3, 9, 700, 200, 144, 4), (3, 16, 700, 200, 144, 4),
                       (3, 33, 700, 200, 144, 4), (2, 41, 1408, 200, 144, 4),
                       (2, 64, 700, 136, 144, 4), (2, 96, 301, 64, 144, 4),
                       (3, 40, 700, 70, 144, 4), (3, 40, 1000, 96, 144, 8),
                       (4, 8, 700, 64, 144, 8), (3, 8, 500, 64, 48, 9),
                       (6, 8, 700, 96, 9, 4), (2, 4, 12000, 16, 1, 4)]


def _wide_codes(seed, shape, bits):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 1 << bits, shape).astype(np.float32))


def _bits_kw(n_rows, bits, level):
    """_depth_kw at `bits`-bit codes: the full scale of a group's MAC."""
    return dict(_depth_kw(n_rows, level),
                full_scale=float(n_rows * ((1 << bits) - 1) ** 2))


def _dense_experts_body(x, w, kw, bits):
    """Which body an expert-batched B2 launch takes: "mma" where the
    launcher reports no knob ({0, 0}, the tensor-core body), else "dense"
    (the dense kernel's body reports the cluster and column warps)."""
    import ctypes
    from repro_torch.kernels import build
    used = (ctypes.c_int * 2)(-1, -1)
    e, m, k = x.shape
    out = torch.empty(e, m, w.shape[2], device=x.device)
    lsb, inv_lsb = cim_mvm.adc_constants(kw["levels"], kw["gain"],
                                         kw["full_scale"])
    assert build.load("cim_mvm").cim_mvm_dense_experts_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), e, m, w.shape[2], k,
        kw["n_rows"], inv_lsb, lsb, float(kw["levels"] - 1), bits, 0, 0,
        used, torch.cuda.current_stream(x.device).cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, cim_mvm.cim_mvm_grouped_experts(
        x, w, **{k_: kw[k_] for k_ in KW}, code_bits=bits))
    return "mma" if (used[0], used[1]) == (0, 0) else "dense"


@pytest.mark.parametrize("level", ["ideal", "noisy", "full"])
@pytest.mark.parametrize("e,m,k,n,n_rows,bits", DENSE_EXPERT_SHAPES)
def test_b2_b5_experts_bit_exact(e, m, k, n, n_rows, bits, level):
    """One expert-batched B2 / B5 launch equals its plain version and one
    2-D launch per expert; every expert draws the 2-D kernel's noise. The
    launch takes the tensor-core body for codes of at most 8 bits in
    groups of a multiple of four rows, the dense kernel's body
    otherwise."""
    dev = gpu_device()
    kw = _bits_kw(n_rows, bits, level)
    x = _wide_codes(e + m, (e, m, k), bits).to(dev)
    w = _wide_codes(n + k, (e, k, n), bits).to(dev)
    if level == "ideal":
        assert _dense_experts_body(x, w, kw, bits) == (
            "mma" if n_rows % 4 == 0 and bits <= 8 else "dense")
    kw = dict(kw, code_bits=bits)
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
    kw.pop("code_bits")
    assert fn.launches == before + 1 and y.shape == (e, m, n)
    assert torch.equal(y, plain(x, w, *args, **kw))
    assert torch.equal(y, torch.stack([wrapper(x[i], w[i], *args, **kw)
                                       for i in range(e)]))


@pytest.mark.parametrize("m", [8, 40])
def test_b2_b5_experts_cuda_graph_replay(m):
    """The tensor-core body of B2e / B5e captured in a CUDA graph: a replay
    after new codes are copied into the captured inputs and a new seed
    into the captured seed tensor gives the plain versions' outputs on
    them."""
    dev = gpu_device()
    e, k, n = 8, 1408, 2048
    x = _codes(1, (e, m, k)).to(dev)
    w = _codes(2, (e, k, n)).to(dev)
    seed = torch.tensor([3], dtype=torch.int32, device=dev)
    nkw = dict(KW, sigma=0.277)
    calls = (lambda: cim_mvm.cim_mvm_grouped_experts(x, w, **KW, code_bits=4),
             lambda: cim_mvm.cim_mvm_grouped_noisy_experts(
                 x, w, seed, **nkw, code_bits=4))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [call() for call in calls]
    x.copy_(_codes(3, (e, m, k)).to(dev))
    w.copy_(_codes(4, (e, k, n)).to(dev))
    seed.fill_(11)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(outs[0], cim_mvm.cim_mvm_grouped_experts_plain(
        x, w, **KW))
    assert torch.equal(outs[1], cim_mvm.cim_mvm_grouped_noisy_experts_plain(
        x, w, seed, **nkw))


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


# ---------------------------------------------------------------------------
# the tuning cache's launch knobs (kernels.autotune) and the 1-rank mesh
# ---------------------------------------------------------------------------
KNOB_SHAPES = [(1, 1, 1), (4, 2048, 2048), (64, 1441, 160), (4, 9000, 48)]
KNOBS = [(c, w) for c in (1, 2, 3, 4, 8) for w in (1, 2, 4, 8)]


def _mvm_calls(x, w, dev):
    """(name, kernel call(**knobs), plain value) of B1, B2, B5, B6 and
    their expert-batched entries on x [M, K] and w [K, N] codes (the
    experts: x and w stacked with their reverses)."""
    wp = ops.pack_codes(w).contiguous()
    xe = torch.stack([x, x.flip(0)]).contiguous()
    we = torch.stack([w, w.flip(0)]).contiguous()
    wpe = ops.pack_codes(we).contiguous()
    seed = torch.tensor([5], dtype=torch.int32, device=dev)
    cm = cim_mvm
    return [
        ("B2", lambda **k: cm.cim_mvm_grouped(x, w, **KW, **k),
         cm.cim_mvm_grouped_plain(x, w, **KW)),
        ("B1", lambda **k: cm.cim_mvm_grouped_packed(x, wp, **KW, **k),
         cm.cim_mvm_grouped_packed_plain(x, wp, **KW)),
        ("B5", lambda **k: cm.cim_mvm_grouped_noisy(x, w, seed, **NOISY, **k),
         cm.cim_mvm_grouped_noisy_plain(x, w, seed, **NOISY)),
        ("B6", lambda **k: cm.cim_mvm_grouped_noisy_packed(x, wp, seed,
                                                           **NOISY, **k),
         cm.cim_mvm_grouped_noisy_packed_plain(x, wp, seed, **NOISY)),
        ("B2e", lambda **k: cm.cim_mvm_grouped_experts(xe, we, **KW, **k,
                                                       code_bits=4),
         cm.cim_mvm_grouped_experts_plain(xe, we, **KW)),
        ("B2e dense body", lambda **k: cm.cim_mvm_grouped_experts(
            xe, we, **KW, **k),
         cm.cim_mvm_grouped_experts_plain(xe, we, **KW)),
        ("B1e", lambda **k: cm.cim_mvm_grouped_packed_experts(xe, wpe, **KW,
                                                              **k),
         cm.cim_mvm_grouped_packed_experts_plain(xe, wpe, **KW)),
        ("B5e", lambda **k: cm.cim_mvm_grouped_noisy_experts(
            xe, we, seed, **NOISY, **k, code_bits=4),
         cm.cim_mvm_grouped_noisy_experts_plain(xe, we, seed, **NOISY)),
        ("B5e dense body", lambda **k: cm.cim_mvm_grouped_noisy_experts(
            xe, we, seed, **NOISY, **k),
         cm.cim_mvm_grouped_noisy_experts_plain(xe, we, seed, **NOISY)),
        ("B6e", lambda **k: cm.cim_mvm_grouped_noisy_packed_experts(
            xe, wpe, seed, **NOISY, **k),
         cm.cim_mvm_grouped_noisy_packed_experts_plain(xe, wpe, seed,
                                                       **NOISY)),
    ]


@pytest.mark.parametrize("m,k,n", KNOB_SHAPES)
def test_mvm_knobs_bit_exact_vs_default_and_plain(m, k, n):
    """Every cluster size and column-warp count the tuning cache may ask
    for gives each MVM kernel (and its expert-batched entry) the default
    launch's bits, which are its plain version's."""
    dev = gpu_device()
    x = _codes(m + 1, (m, k)).to(dev)
    w = _codes(n + 2, (k, n)).to(dev)
    for name, call, plain in _mvm_calls(x, w, dev):
        default = call()
        assert torch.equal(default, plain), name
        for cluster, wcols in KNOBS:
            assert torch.equal(call(cluster=cluster, wcols=wcols),
                               default), (name, cluster, wcols)


def test_mvm_knob_the_launcher_cannot_take_is_clamped_and_counted():
    """A packed geometry whose codes do not fit in shared memory (57
    groups on one rank with 8 column warps) falls back to the launcher's
    choice: the same bits, one clamp counted, no error."""
    from repro_torch.runtime.telemetry import KERNEL_COUNTERS
    dev = gpu_device()
    x = _codes(1, (64, 8192)).to(dev)
    wp = ops.pack_codes(_codes(2, (8192, 256)).to(dev)).contiguous()
    default = cim_mvm.cim_mvm_grouped_packed(x, wp, **KW)
    KERNEL_COUNTERS.reset()
    out = cim_mvm.cim_mvm_grouped_packed(x, wp, **KW, cluster=1, wcols=8)
    assert torch.equal(out, default)
    assert KERNEL_COUNTERS.tune_cache["cim_mvm:clamp"] == 1
    KERNEL_COUNTERS.reset()


@pytest.mark.parametrize("c", [1, 5, 16])
@pytest.mark.parametrize("splits", range(1, 9))
def test_b3_every_split_bit_exact_vs_plain_at_that_split(splits, c):
    """B3 at every S the tuning cache may set (1 .. min(8, MB)) equals its
    plain version at the same S, and the decode launch (B4 folded in)
    equals B4 then B3 plain at that S."""
    dev = gpu_device()
    case = _attn_case(11, c, torch.float32, dev, mb=16)
    assert torch.equal(pa.paged_attn_call(*case, splits=splits),
                       pa.paged_attn_plain(*case, splits))
    if c != 1:
        return
    q, kp, vp, tables, lens, kvl = case
    rng = np.random.RandomState(12)
    new = [torch.from_numpy(rng.standard_normal(
        (q.shape[0], 1, kp.shape[2], kp.shape[3])).astype(np.float32))
        .to(dev) for _ in range(2)]
    flat = (tables[:, 0].long() * kp.shape[1] + 1).to(torch.int32)
    flat[0] = 0
    pools = [(kp.clone(), vp.clone()) for _ in range(2)]
    out = pa.decode_write_attend_call(q, *pools[0], *new, flat, tables,
                                      lens, kvl, splits=splits)
    ref = pa.decode_write_attend_plain(q, *pools[1], *new, flat, tables,
                                       lens, kvl, splits)
    assert torch.equal(out, ref)
    assert all(_same_bits(a, b) for a, b in zip(pools[0], pools[1]))


def test_one_rank_nccl_mesh_mvm_identical_to_no_mesh():
    """A 1-rank nccl mesh: cim_matmul and cim_matmul_prequant (dense and
    packed codes) at IDEAL and NOISY give no mesh's bits (salt 0)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.core.cim_matmul import (CIMConfig, cim_matmul,
                                             cim_matmul_prequant,
                                             quantize_weight_offline)
    from repro_torch.core.macro import SimLevel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding
    dev = gpu_device()
    owned = not dist.is_initialized()
    mesh = make_host_mesh(1, 1)
    try:
        rng = np.random.RandomState(9)
        for m in (4, 64):
            x = torch.from_numpy(rng.standard_normal((m, 2048))
                                 .astype(np.float32)).to(dev)
            w = torch.from_numpy((rng.standard_normal((2048, 1024)) * 0.02)
                                 .astype(np.float32)).to(dev)
            for level in (SimLevel.IDEAL, SimLevel.NOISY):
                cfg = CIMConfig(enabled=True, noise_seed=0,
                                macro=dataclasses.replace(
                                    CIMConfig().macro, sim_level=level))
                codes, s_w = quantize_weight_offline(w, cfg)
                calls = (lambda: cim_matmul(x, w, cfg),
                         lambda: cim_matmul_prequant(x, codes, s_w, cfg),
                         lambda: cim_matmul_prequant(
                             x, ops.pack_codes(codes), s_w, cfg))
                for call in calls:
                    sharding.set_mesh(None)
                    plain = call()
                    sharding.set_mesh(mesh)
                    assert torch.equal(call(), plain), (m, level)
    finally:
        sharding.set_mesh(None)
        if owned:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# expert parallelism and the KV-head split: the per-shard launches of a
# rank of an ep-rank "model" axis
# ---------------------------------------------------------------------------
EP_RANKS = (2, 4, 8)
# qwen2-moe-a2.7b at full width: 60 experts padded to 64, d_model 2048,
# d_ff_expert 1408; capacity 8 (a decode step's)
EP_PROJ = [(2048, 1408), (1408, 2048)]


def _expert_kernels(kid, dev):
    """(kernel, plain version, extra args) of an expert-batched entry."""
    seed = (torch.tensor([7], dtype=torch.int32, device=dev),)
    return {"B1e": (cim_mvm.cim_mvm_grouped_packed_experts,
                    cim_mvm.cim_mvm_grouped_packed_experts_plain, ()),
            "B6e": (cim_mvm.cim_mvm_grouped_noisy_packed_experts,
                    cim_mvm.cim_mvm_grouped_noisy_packed_experts_plain,
                    seed),
            "B2e": (cim_mvm.cim_mvm_grouped_experts,
                    cim_mvm.cim_mvm_grouped_experts_plain, ()),
            "B5e": (cim_mvm.cim_mvm_grouped_noisy_experts,
                    cim_mvm.cim_mvm_grouped_noisy_experts_plain, seed)}[kid]


@pytest.mark.parametrize("c", [8, 40])
@pytest.mark.parametrize("k,n", EP_PROJ)
@pytest.mark.parametrize("kid", ["B1e", "B6e", "B2e", "B5e"])
def test_expert_slices_bit_exact_vs_whole_launch(kid, k, n, c):
    """Each rank's expert slice (E_pad / ep experts, a leading-dim narrow
    of the whole stack, launched as it is) equals the matching experts of
    the whole launch and its plain version, bit for bit, for ep 2, 4, 8,
    at capacity 8 (decode) and 40 (qwen2-moe's training)."""
    dev = gpu_device()
    fn, plain, args = _expert_kernels(kid, dev)
    kw = dict(KW, sigma=0.277) if args else KW
    bits = {"code_bits": 4} if kid in ("B2e", "B5e") else {}
    e = 64
    x = _codes(k + c, (e, c, k)).to(dev)
    w = _codes(n, (e, k, n)).to(dev)
    if kid in ("B1e", "B6e"):
        w = ops.pack_codes(w).contiguous()
    whole = fn(x, w, *args, **kw, **bits)
    for ep in EP_RANKS:
        el = e // ep
        for r in range(ep):
            xs, ws = x.narrow(0, r * el, el), w.narrow(0, r * el, el)
            assert ws.is_contiguous()
            before = fn.launches
            y = fn(xs, ws, *args, **kw, **bits)
            assert fn.launches == before + 1
            assert torch.equal(y, whole[r * el:(r + 1) * el]), (ep, r)
            assert torch.equal(y, plain(xs, ws, *args, **kw)), (ep, r)


# (KH, G): internlm2-1.8b (16 / 8 heads) and qwen2-moe-a2.7b (16 / 16),
# dh 128
HEAD_SPLITS = [(8, 2), (16, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 16])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("kh,g", HEAD_SPLITS)
def test_b3_head_slice_bit_exact_vs_whole_launch(kh, g, bs, c, dtype):
    """B3 on each rank's KV-head slice of the pools (a strided view read in
    place, ep 2, 4, 8) equals the slice of the whole launch and its plain
    version on the same view, bit for bit; at C = 1 the unfused route
    (paged_write of the whole pools, then B3 on the slice) gives the
    one-launch decode's output slice and pools."""
    from repro_torch.models.common import paged_write
    dev = gpu_device()
    mb = 16 if bs == 16 else 4
    q, kp, vp, tables, lens, kvl = _attn_case(13, c, dtype, dev, kh=kh, g=g,
                                              bs=bs, mb=mb)
    q = q.to(dtype)
    whole = pa.paged_attn_call(q, kp, vp, tables, lens, kvl, out_dtype=dtype)
    if c == 1:
        nk, nv, flat = _decode_writes((q, kp, vp, tables, lens, kvl), dtype,
                                      dev)
        kf, vf = kp.clone(), vp.clone()
        fused = pa.decode_write_attend_call(q, kf, vf, nk, nv, flat, tables,
                                            lens, kvl, out_dtype=dtype)
        ku, vu = kp.clone(), vp.clone()
        paged_write(ku, nk, flat.long()[:, None])
        paged_write(vu, nv, flat.long()[:, None])
        assert _same_bits(ku[1:], kf[1:]) and _same_bits(vu[1:], vf[1:])
        with pytest.raises(ValueError, match="whole pools"):
            pa.decode_write_attend_call(q[:, :, :g], kf[:, :, :1],
                                        vf[:, :, :1], nk[:, :, :1],
                                        nv[:, :, :1], flat, tables, lens,
                                        kvl)
    for ep in EP_RANKS:
        khl = kh // ep
        for r in range(ep):
            heads = slice(r * khl * g, (r + 1) * khl * g)
            qs = q[:, :, heads].contiguous()
            ks, vs = kp.narrow(2, r * khl, khl), vp.narrow(2, r * khl, khl)
            assert not ks.is_contiguous() or khl == kh
            before = pa.paged_attn_call.launches
            y = pa.paged_attn_call(qs, ks, vs, tables, lens, kvl,
                                   out_dtype=dtype)
            assert pa.paged_attn_call.launches == before + 1
            assert _same_bits(y, whole[:, :, heads].contiguous()), (ep, r)
            assert _same_bits(y, pa.paged_attn_plain(
                qs, ks, vs, tables, lens, kvl).to(dtype)), (ep, r)
            if c == 1:
                yu = pa.paged_attn_call(
                    qs, ku.narrow(2, r * khl, khl),
                    vu.narrow(2, r * khl, khl), tables, lens, kvl,
                    out_dtype=dtype)
                assert _same_bits(yu, fused[:, :, heads].contiguous())


def test_one_rank_nccl_mesh_moe_and_a2a_identical_to_no_mesh():
    """A 1-rank nccl mesh: the smoke qwen2-moe's moe.apply with packed
    experts at IDEAL and NOISY, psum-EP and a2a-EP, gives no mesh's bits
    with the same B1e / B6e launches; the a2a exchange's all-to-alls on
    the 1-rank group give the send buffer back bit for bit."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.registry import SMOKES
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.core.macro import SimLevel
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe, registry
    from repro_torch.models.quantize import quantize_params
    from repro_torch.parallel import collectives, sharding
    dev = gpu_device()
    owned = not dist.is_initialized()
    mesh = make_host_mesh(1, 1)
    try:
        base = SMOKES["qwen2-moe-a2.7b"]
        ffn = registry.init_params(base, seed=0, device=dev,
                                   max_seq=64)["layers"][1]["ffn"]
        x = torch.from_numpy(np.random.RandomState(14).standard_normal(
            (4, 16, base.d_model)).astype(np.float32)).to(dev, torch.bfloat16)
        for level in (SimLevel.IDEAL, SimLevel.NOISY):
            cim = CIMConfig(enabled=True, noise_seed=0, macro=dataclasses
                            .replace(CIMConfig().macro, sim_level=level))
            p = quantize_params(ffn, base.replace(cim=cim))
            for mode in ("psum", "a2a"):
                cfg = base.replace(cim=cim, moe=dataclasses.replace(
                    base.moe, ep_mode=mode))
                for t in (16, 1):
                    sharding.set_mesh(None)
                    build.reset_launch_counts()
                    y0, a0 = moe.apply(p, x[:, :t], cfg)
                    n0 = build.launch_counts()
                    sharding.set_mesh(mesh)
                    build.reset_launch_counts()
                    y1, a1 = moe.apply(p, x[:, :t], cfg)
                    assert build.launch_counts() == n0
                    assert torch.equal(y0, y1) and torch.equal(a0, a1)
        send = torch.from_numpy(np.random.RandomState(15).standard_normal(
            (64, 8, 2048)).astype(np.float32)).to(dev)
        group = mesh.get_group("model")
        recv = collectives.dispatch_exchange(send, group)
        assert recv.shape == send.shape and torch.equal(recv, send)
        assert torch.equal(collectives.combine_exchange(recv, group), send)
    finally:
        sharding.set_mesh(None)
        if owned:
            dist.destroy_process_group()


def test_one_rank_nccl_mesh_placed_trainer_identical_to_no_mesh(tmp_path):
    """The Trainer with its state placed on a 1-rank nccl mesh (no leaf is
    cut there) takes two steps of the smoke internlm2 at --cim bp: its
    losses, params and AdamW state equal no mesh's bit for bit, with the
    same 29 B2 launches a step."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import SMOKES
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding
    from repro_torch.runtime.trainer import Trainer
    dev = gpu_device()
    owned = not dist.is_initialized()
    mesh = make_host_mesh(1, 1)
    cfg = SMOKES["internlm2-1.8b"].replace(cim=_cim("ideal"))
    runs = []
    try:
        for m in (mesh, None):
            sharding.set_mesh(m)
            tr = Trainer(cfg, ShapeConfig("tiny", 32, 4, "train"),
                         TrainConfig(steps=10, lr=1e-3), str(tmp_path),
                         device=dev)
            assert tr.specs is None
            state = tr.init_state()
            losses, counts = [], []
            for i in range(2):
                build.reset_launch_counts()
                state, metrics = tr.step_fn(state, tr.batch(i))
                torch.cuda.synchronize()
                counts.append(build.launch_counts()["cim_mvm_grouped"])
                losses.append(metrics["loss"])
            runs.append((state, losses, counts))
    finally:
        sharding.set_mesh(None)
        if owned:
            dist.destroy_process_group()
    (s1, l1, c1), (s0, l0, c0) = runs
    assert all(torch.equal(a, b) for a, b in zip(l1, l0))
    assert _same_tree(s1, s0)
    assert c1 == c0 == [29, 29]
