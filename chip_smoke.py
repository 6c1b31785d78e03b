#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA device. It imports
only the port (`src/repro_torch`), never JAX or the JAX package, and exits
non-zero without a CUDA device or without the port beside it. Phases, each
of which fails the run when it fails:

  1. the card's name and power limit (nvidia-smi); build the Hopper kernels
     B1-B6 (one nvcc per source, started together) and time the build;
  2. each kernel against its plain PyTorch version on the card at the main
     path's shapes, from numpy-seeded inputs: B1/B2 (grouped ADC MVM,
     packed/dense) bit-exact at M in {4, 64} over the internlm2-1.8b layer
     and head widths; B5/B6 (the same with the seeded NOISY converter)
     bit-exact at the same shapes for seeds 0 and 7, B6 equal to B5, the
     inl_seed salt changing the draws, and FULL (INL curve) at one layer
     shape; B3 (paged flash attention) at decode C=1 and prefill C=16 with
     mixed lengths, an idle lane and a NaN trash block, bit-exact and
     finite; B4 (the decode K/V write), which runs inside B3's decode
     launch: that launch bit-exact against B4's plain version then B3's
     (outputs and both pools, f32 and bf16 q/output). Each is timed with
     CUDA events beside its plain version, a bound and, where one exists,
     a PyTorch library call (the MVM kernels over one decode step's 169
     MVMs and over a prefill chunk's 168 layer MVMs at M=64, logged per
     shape; B3 at decode and at the prefill chunk; B4 as the decode
     launch's time less B3's alone at the same shapes); B3 alone and the
     B3+B4 decode launch at the head dims and block sizes past the fast
     case (dh 16, 20, 56, 80, 128 x bs 16, 48, 64, 128; bf16 and f32 pools)
     bit-exact against their plain versions; B3 timed at decode at dh 80 /
     bs 16 and dh 128 / bs 64 and at a verify step (C = 5), and B1 over a
     verify step's MVMs (M = 20); B1, B2, B5 (NOISY and FULL) and B6
     bit-exact against their plain versions at every ADC level of the
     precision search's ladder (L in 32 ... 256), M in {4, 64}, K 2048,
     N 8192;
  3. full-width internlm2-1.8b (24 layers, d_model 2048, vocab 92544,
     random weights from a torch.Generator seed) served through `Server`
     with --cim bp-prequant and the kernel attention: 8 requests, two
     sharing a 32-token prefix, SERVE_NEW_TOKENS (16) new tokens each (as
     in phases 3p, 4b and 3l; the repeated serves of phases 3s, 3m and 3r
     serve SHORT_NEW_TOKENS, 8, since phase 3f was added, to keep the
     script's time). Launch counts are reset just before and read just
     after; B1, B3 (prefill) and the B3+B4 decode launch must
     each have launched. Then one prefill and one decode `paged_step`
     with the kernels and with their plain versions, which must give
     identical logits, and where one decode step's time goes (CUDA graph
     vs eager, launches per step, profiler rows);
  3s. speculative decoding at phase 3's width and settings: one verify
     step (C = 5, every position's logits) with the kernels and with their
     plain versions, identical logits and pools; phase 3's 8 requests
     served greedily with the ngram drafter at spec_k 4 (accept statistics
     printed), then twice sampled (temperature 0.7, top-k 8, seeds 0-7),
     which must give identical streams;
  3t. telemetry, parallel samples and the trie watermark sweep at phase
     3's width and settings (`telemetry=True`, `trie_watermark=0.25`):
     phase 3's 8 requests, 0 and 1 at n_samples 2 (submitted first, so
     their clones install the step their parent's prefill completes and
     decode in lockstep with it), greedy, 16 new tokens each; three
     drains with telemetry on and two with it off, in turns. Each clone
     must equal its parent, cow_forks and trie_sweep_freed must be > 0,
     the off drains must give the on drains' streams, the Chrome trace
     must validate, KERNEL_COUNTERS' per-call counts must equal the
     kernels' launch counts (cuda_packed = B1; kernel = B3 + the decode
     launch), and the recording hooks (timed on the instance, as the
     reference's serve_slo bench times them) must take under 3 % of the
     step() wall (median of the on drains). Prints TTFT / ITL p50 / p99,
     the event counts, the Prometheus line count, the host cost of the
     169 per-call KERNEL_COUNTERS updates of one decode step and tok/s
     with telemetry on and off;
  3l. the slot engine (`ServingConfig()`, paged=False) at phase 3's
     width with --cim bp-prequant, 4 slots, max_len 256: phase 3's 8
     requests served twice on fresh servers, which must give identical
     streams, with launch counts reset just before and read just after
     the first (B1 must launch 169 times per decode step and per
     prefill; the paged attention kernel never); one per-request prefill
     (the 96-token prompt, B1 at M = 96) and one decode step with the
     kernels and with their plain versions, which must give identical
     logits and caches; the slot decode step on the card (CUDA graph) vs
     eager and its launches; B1 over a 96-token prefill's 168 layer MVMs
     timed against its bound. Then, at smoke size and --cim off, the
     paged spec Server with the model drafter (spec_k 4) sharing the
     target's weights against plain greedy: a draft must be accepted;
     accept rate, mean accept length and target steps are printed;
  dryrun. the lowering analysis (`launch.dryrun`, `phase_dryrun`, after
     phase 3l on its second server's model): (a) the reference's CI cells
     through `run_cell` (internlm2-1.8b decode_32k on the planned 512-chip
     mesh and train_4k on the 256-chip one, llama3-8b long_500k, which
     must be skipped with the reference's reason, internlm2-1.8b
     decode_32k --cim bp-prequant, qwen2-moe-a2.7b decode_32k --mesh
     host --ep a2a on this card's 1-rank nccl mesh), each status line and
     its seconds; (b) the dry-run's cost counter on the meta device at
     phase 3l's own shape (the slot decode step, 4 slots, max_len 256,
     full width, --cim bp-prequant, one chip): the planned argument bytes
     must equal the real params', cache's and tokens' bytes exactly, and
     the MVMs the trace dispatched the B1 launches of one real step
     (169); the planned temp bytes beside the measured
     max_memory_allocated growth of one real step, and the roofline's
     three terms (the H100's data-sheet peaks) beside the step's CUDA
     graph time; (c) the phase's seconds (limit DRYRUN_LIMIT_S);
  3p. calibrated static grids and precision manifests at phase 3's width
     and settings: (a) calibrate_act_scale and calibrate_act_tree on the
     reference launcher's batch (RandomState(7), 2 x 16 tokens), the grid
     and per-site spans logged; (b) the precision search with the
     reference test's settings (bit_candidates (7.0,), no per-channel
     retry), its manifest written under build/; (c) phase 3's 8 requests
     served --paged --cim bp-prequant three ways (the static grid, the
     searched manifest, the committed precision_manifest.json), each with
     169 B1 launches per step and its per-site energy logged against the
     uniform 362-level energy of the same dots; (d) under both manifests,
     one prefill and one decode paged_step with the kernels and with their
     plain versions, which must give identical logits and pools; (e) under
     the static grid, a probe request's stream served alone must equal its
     stream beside 3 companions; (f) the host time of one decode step's 169
     site resolutions, and the manifest and static-grid decode steps on the
     card (CUDA graph) vs eager;
  4. a short --cim bp serve, which must launch B2, and the decode step
     breakdown of that server (B2's share of the step);
  4b. the seeded stochastic converter (SimLevel.NOISY, noise_seed 0) at
     full width: phase 3's serve with nibble-packed prequant weights (B6,
     B3 and the B3+B4 decode launch must launch), the kernel-vs-plain step
     check and the decode
     step breakdown again, then a short --cim bp-noisy serve with weights
     quantized on the fly, which must launch B5;
  tune. the kernel tuning cache (`phase_tune_mesh`, after phase 4b, on
     phase 3's model and settings): B1 at the decode MVM shapes (M = 4:
     the layer widths and the head) at every cluster size x column-warp
     candidate of `kernels.autotune.mvm_candidates`, each bit-exact
     against the default launch and the plain version, timed (CUDA
     graph); the decode launch (B3 + B4, dh 128, bs 16, MB 16, bf16) at
     every split S from 1 to 8, each bit-exact against B4 then B3 plain
     at that S, timed; the winners written with `save_cache` to a
     temporary file; phase 3's 8 requests (SHORT_NEW_TOKENS) served
     untuned and under the cache (hits counted, no clamp, the same
     launches; identical streams if the default S won, else the tuned
     steps held kernels vs plain at that S); a malformed cache serves
     with one warning and one counted fallback;
  mesh. a 1-rank mesh (`make_host_smoke_mesh`, nccl): B1 and B6 through
     the sharded dispatch at the decode and prefill shapes (M 4 and 64)
     of every layer MVM and the head, bit-identical to no mesh; the
     sharded dispatch's host cost (one decode MVM, MESH_PAIRS pairs of
     passes of MESH_CALLS calls without and with the mesh); phase 3's serve on the mesh (`serve.py --mesh host`'s mesh), whose
     streams and B1 / B3 / decode launch counts must equal the untuned
     serve's;
  fsdp. the Trainer's placed state (`phase_fsdp`, inside phase mesh, on
     its 1-rank nccl mesh): full-width internlm2-1.8b cut to FSDP_LAYERS
     layers, --cim bp, FSDP_STEPS steps of the Trainer's step from its
     init_state on the mesh and without one: losses, params and AdamW
     state bit-identical, B2 on every MVM and its launches equal; then
     rank 0's bytes of full-depth qwen2-moe-a2.7b's params + AdamW state
     as placed on the meta device under (data 4, model 1) and (data 2,
     model 2), beside the card's 80 GB;
  5. B2/B5 at macro depths 9, 145 and 1024 (M in {4, 64}) bit-exact
     against their plain versions, B1/B6 equal to them at the even depth;
  3m. the MoE family at full width (run after phase 5, once phase 3's
     model is freed): (a) B1 and B6's expert-batched entries (B1e, B6e:
     64 experts x capacity 8, K 2048 -> N 1408 and K 1408 -> N 2048)
     bit-exact against their plain versions and against 64 2-D launches
     (B6e at seeds 0 and 7), timed over one layer's three expert MVMs
     against the bound of their bytes or hash operations; (b)
     qwen2-moe-a2.7b (24 layers, d_model 2048, 60 routed experts padded
     to 64, top-4, 4 gated shared experts, vocab 151936; random weights
     from a torch.Generator seed) initialised and quantized layer by
     layer, peak memory printed; (c) one prefill and one decode
     paged_step over the first M_PLAIN_LAYERS layers with the kernels and
     with their plain versions: identical logits and pools; (d) phase 3's 8 requests served --paged --cim
     bp-prequant with the kernel attention (B1, B1e, B3 and the B3+B4
     decode launch must launch), the decode step on the card (CUDA graph)
     vs eager, then twice at SimLevel.NOISY, noise_seed 0 (B6, B6e, B3 and
     the decode launch must launch; the kernel-vs-plain steps; the two
     same-seed serves must give identical streams); then phase "ep"
     (`phase_ep`, while the model is loaded): B1e / B6e / B2e / B5e on
     every rank's expert slice of ep 2, 4 and 8 (a leading-dim narrow of
     the 64 experts, launched as it is) bit-exact against the whole
     launch and the plain version, rank 0's timed; B3 on every rank's
     KV-head slice (KH 8 and 16, bs 16 and 64, C 1 and 16; the pools read
     in place) bit-exact against the whole launch and the plain version,
     timed beside the whole launch; the a2a exchange through nccl's
     all_to_all_single on the 1-rank group; phase 3m's serves on the
     1-rank nccl mesh, psum-EP at IDEAL and a2a-EP at NOISY, whose
     streams and launch counts must equal (d)'s; (e) stablelm-3b
     (head dim 80 through B3's GEN instances, LayerNorm, qkv bias,
     partial rotary), llama3-8b (GQA 32 / 8, vocab 128256), granite-3-8b
     (the tied head: embed.T through B2) and internvl2-26b's decoder (48
     layers, d_model 6144, GQA 48 / 8, vocab 92553; ~37.5 GB of bf16
     never held whole) at full width (llama3-8b's n_layers cut from 32
     and granite-3-8b's from 40 to 4, E_DEPTH, since phase 3w was added,
     to keep the script's time), each initialised and
     quantized layer by layer: one prefill and one decode paged_step
     each, kernels vs plain, identical logits and pools; for internvl2
     also one slot-engine prefill of 256 numpy-seeded image embeddings
     [1, 256, 6144] in front of 32 tokens, kernels vs plain, identical
     logits and K/V, B1 launched once per stored matrix, and its paged
     decode step on the card (CUDA graph) vs eager, its launches and the
     card's idle share;
  3d. deepseek-v3 (run after phase 3m, once its models are freed): (a) B2
     and B5's expert-batched entries (B2e, B5e: 256 experts x capacity 8,
     K 7168 -> N 2048 and K 2048 -> N 7168, f32 code containers of 15 GB)
     bit-exact against their plain versions and against 256 2-D launches
     (B5e at seeds 0 and 7), timed over one layer's three expert MVMs
     against the bound of their bytes or hash operations; (b)
     deepseek-v3-671b with every matrix at full width (d_model 7168, 128
     heads, q / kv LoRA 1536 / 512, 256 routed experts top-8, d_ff_dense
     18432, vocab 129280) and n_layers cut to first_dense + 1 (three dense
     layers, one MoE layer; the full model's routed experts hold 654 G
     codes), random weights from a torch.Generator seed, the expert
     stacks drawn in chunks, peak memory printed; (c) one per-request
     prefill (96 tokens) and one decode step through the slot engine's
     prefill / decode_step at --cim bp (IDEAL) and bp-noisy (NOISY,
     noise_seed 0), kernels vs plain: identical logits and latent caches,
     B2e / B5e launched 3 times per MoE layer and forward; (d) phase 3's 8
     requests, 8 new tokens each (16 before phase 3w was added, cut to
     keep the script's time), served through the slot engine at --cim
     bp, then twice at
     --cim bp-noisy (B2e / B5e launched exactly 3 times per MoE layer per
     forward; the two NOISY serves must give identical streams), the
     decode step on the card (CUDA graph) vs eager, its launches and the
     card's idle share. Each part prints its seconds;
  3r. the recurrent archs (run after phase 3d, once its model is freed):
     rwkv6-7b (32 layers, d_model 4096, 64 heads of 64, d_ff 14336, vocab
     65536), then zamba2-2.7b (54 Mamba2 layers, d_model 2560, d_inner
     5120, N 64, the weight-shared attention block of 32 heads of 80 and
     d_ff 10240 after every 6th layer, vocab 32000), each at full width
     and depth with random weights from a torch.Generator seed,
     initialised and quantized layer by layer, on the slot engine (4
     slots, max_len 256), phase 3's token ids folded into the arch's
     vocab: (a) one per-request prefill (prompt 0) and one decode step at
     --cim bp-prequant, IDEAL (B1) and NOISY (B6, noise_seed 0), kernels
     vs plain: max |dlogit| 0 and every recurrent state, conv history and
     shared K/V identical, B1 / B6 launched once per stored matrix and
     forward; for zamba2 the same pair at --cim bp-noisy on float weights
     (B5); (b) phase 3's 8 requests at IDEAL, then twice at NOISY (the two
     NOISY serves must give identical streams); (c) the decode step on the
     card (CUDA graph) vs eager at IDEAL and NOISY, its launches, the
     card's idle share, peak memory and the phase's seconds. Each model
     is freed before the next loads;
  3w. whisper-large-v3 (run after phase 3r, once its models are freed) at
     full width and depth: 32 encoder and 32 decoder layers, d_model 1280,
     20 heads of 64, d_ff 5120, vocab 51866, 1500 frames, max_seq 448;
     random weights from a torch.Generator seed, initialised and quantized
     layer by layer in bf16 (stored codes and packed bytes logged): (a) one
     prefill of 2 requests (1500 numpy-seeded stub frames each, 4 prompt
     tokens) and W_STEPS (4; 8 before phase 3f was added) greedy decode
     steps at IDEAL (B1), then twice at NOISY
     (B6, noise_seed 0), each with the kernels and with their plain
     versions: identical logits, streams and caches (self and cross K/V),
     the two NOISY runs identical, B1 / B6 launched exactly 513 times a
     prefill (encoder 32 x 6, decoder 32 x 10, head) and 257 a decode step
     (32 x 8 + 1); (c) the encoder's and the prefill's seconds, the decode
     step (2 requests at pos 100) on the card (CUDA graph) vs eager, its
     launches, the card's idle share and profiler rows, at IDEAL and
     NOISY; (b) one prefill and decode step at --cim bp-noisy from the
     float weights (B5), kernels vs plain, identical; peak memory and the
     phase's seconds;
  3g. the paper's KWS GRU (d 144, gates [288, 144], 12 classes): the
     example's float training (300 full-batch SGD steps over numpy-seeded
     synthetic keywords, `repro_torch.examples.kws_gru`) on the card, the
     loss falling and float accuracy > 0.9; then forwards over the 512
     test sequences from stored codes at gain 3, IDEAL (B1) and FULL with
     noise_seed 0 at the example's five PVT corners (B6), each with the
     kernels and with their plain versions: identical logits, 37 launches
     a forward; accuracies logged;
  3x. training (`phase_train`): (a) one AdamW train step of
     internlm2-1.8b at full width with n_layers cut to 2 (the full-vocab
     head kept), batch 2 x seq 64, --cim bp, with the kernels and with
     their plain versions (CIM backend "plain"): identical loss,
     gradients, grad norm and updated params / m / v; B2 launched 29
     times (7 a layer, twice under per-layer remat, + the head); (b)
     cim_matmul's gradients through the einsum VJP at a layer's shapes,
     kernels vs plain identical, one B2 launch a forward and none in the
     backward; (c) the full 24-layer model through launch.train's Trainer
     (--cim bp, batch 2 x seq 256, AdamW) for 4 steps: finite losses, 337
     B2 launches a step, step times and peak memory, then steps 2-3 run
     again from the step-2 state held on the card (a step never writes
     its input state): identical losses and params; one profiled step
     (kernel time against the step's wall: the card's idle share); (d)
     the train_cim_qat example for 40 steps (float, then --cim bp), its
     final-loss gap;
  3y. the remaining training legs (`phase_train_legs`): (0) B2's
     expert-batched entry (B2e) at qwen2-moe-a2.7b's train capacity (64
     experts x 40 rows) and B2 at M = 512, one MoE layer's forward MVMs
     each, bit-exact against their plain versions and timed against their
     bounds; (a) qwen2-moe-a2.7b at full width, --cim bp, batch 2 x seq
     256: a 1-layer AdamW step with the kernels and with their plain
     versions (identical loss, gradients, grad norm, params, m and v; B2e
     launched 6 times, B2 15), then 2 layers through the Trainer for 3
     steps (12 B2e and 29 B2 launches a step, step times, peak memory),
     steps 1-2 again from the state held before step 1 (identical), and
     one profiled step (the card's idle share); (b) one step each, kernels
     vs plain identical, of deepseek-v3 at its 3 dense MLA layers with the
     MTP loss (Adafactor), rwkv6-7b at 2 layers, zamba2-2.7b at 6 (one
     shared-block application), whisper-large-v3 at 2 + 2 layers over 2 x
     1500 frames and internvl2-26b at 1 layer behind 256 image tokens, all
     at full width;
  3f. the paper's figures and the examples (after 3y): (a)
     `repro_torch.figures.run` once, in process, on the card: its 74 rows
     (Figs. 1b-21 and Table I at the reference's sizes: Fig. 2's 8192
     Monte-Carlo samples, the 64 -> 144 -> 16 classifier on 4096 / 1024
     points trained three times, Fig. 16's 50 x 256 x 8 conversions, Fig.
     15's 32,768-point sweeps), each module's seconds, no ERROR and no
     non-finite number; the paper anchors recomputed in the port (sigma_E
     0.59 LSB, 40.2 / 18.6 TOPS/W at 0.65 / 1.2 V); B2 launched exactly 16
     times (once per IDEAL BP cim_matmul: Fig. 1b's BP row 2, Fig. 10's
     seven ladder rungs 14), no other kernel; (b) B2 bit-exact against its
     plain version at the figures' shapes (x [1024, 64] x [64, 144], a
     single partial group; [1024, 144] x [144, 16]; quickstart's [8, 288]
     x [288, 16]) at each of Fig. 10's seven ladders (L 32 ... 1024),
     timed at L 362 against its bound, with its kernel body (torch.profiler,
     read right after phase 2: at the end of the script the profiler
     records no rows for these calls); (c) the quickstart, sqnr_study and
     serve_decode examples on the card (serve_decode --cim on the slot
     engine and --cim --paged), their output, seconds and launches (B2 3
     in quickstart, none in sqnr_study; B2, and with --paged B3 and the
     decode launch, in the serves); before each serve, one prefill and
     one decode step of its engine on its model (the smoke internlm2:
     d_model 128, d_ff 256, heads of 32, blocks of 8) with the kernels and
     with their plain versions: identical logits and K/V (tolerance 0),
     B2 (and B3 and the decode launch) launched, the plain steps
     launching nothing;
  6. a `kernels` JSON line (launches: B1, B3 and the decode launch from
     phase 3t's first drain, B2 from phase 4, B5 and B6 from phase 4b,
     B1e from phase 3m's IDEAL serve and B6e from its first NOISY serve,
     each plus phase "ep"'s serve on the 1-rank mesh,
     B2e from phase 3d's --cim bp serve and B5e from its first --cim
     bp-noisy serve; B2's launches in a train step are on phase 3x's
     lines, B2e's and B2's in a MoE train step on phase 3y's; phase 3f's
     launches of B2, B3 and the decode launch are added to theirs), then
     the result line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:    # the card's data-sheet peaks, from the port's one source of them
    from repro_torch.analysis.roofline import F32_FLOPS as F32_FLOP_S
    from repro_torch.analysis.roofline import HBM_BW as HBM_BYTES_S
    from repro_torch.analysis.roofline import INT8_OPS as INT_OP_S
except ImportError:     # no port beside this file: main() says so, exits 2
    HBM_BYTES_S = F32_FLOP_S = INT_OP_S = None
# H100 SXM int32 outside the tensor cores: 132 SMs x 64 INT32 lanes (half
# the 128 FP32 lanes that give the data sheet's 67 TFLOP/s) x 1.98 GHz
INT32_OP_S = 132 * 64 * 1.98e9
# integer operations the counter hash of B5/B6 needs (murmur3 finalizer
# mix32 = 3 shifts + 3 xors + 2 multiplies = 8): per conversion, the group
# absorption (xor + mix32) and 12 uniforms (add + mix32 each); per output
# element, the row and column absorptions (2 x (xor + mix32))
HASH_OPS_PER_CONVERSION = 9 + 12 * 9
HASH_OPS_PER_OUTPUT = 2 * 9
FULL_TOL = 0                   # outputs of B5/B6 at FULL that may differ

# (name, rows of the decode-step MVM shapes: K, N, launches per step)
DECODE_MVMS = [("wq+wo", 2048, 2048, 48), ("wk+wv", 2048, 1024, 48),
               ("w_gate+w_up", 2048, 8192, 48), ("w_down", 8192, 2048, 24),
               ("head", 2048, 92544, 1)]
PARITY_KN = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048),
             (2048, 92544)]
MESH_CALLS = 100               # calls a pass of phase mesh's host timing
# phase fsdp: the Trainer's depth, batch x seq and steps on the mesh
FSDP_LAYERS, FSDP_BATCH, FSDP_SEQ, FSDP_STEPS = 2, 2, 64, 2
# ... and the planned meshes of qwen2-moe's placed state
FSDP_PLANS = ({"data": 4, "model": 1}, {"data": 2, "model": 2})
MESH_PAIRS = 10                # (no mesh, mesh) pairs of those passes
DEPTHS = (9, 145, 1024)        # macro depths of phase 5 (the default is 144)
# B3's head dims and block sizes past its fast case (dh in {32, 64, 128,
# 256}, bs <= 32): bf16 rows of dh 20 are 40 bytes; dh 56 is deepseek-v3's
# d_model / n_heads (its MLA attention never reaches B3: q/k head dim 192,
# V 128), dh 80 stablelm-3b's
C1_SHAPES = ((16, 16), (80, 16), (56, 16), (20, 16), (128, 48), (128, 64),
             (80, 128))
SPEC_K = 4
# the ADC levels of the precision search's ladder below the native 362
# (core.precision.ADC_BIT_CANDIDATES: 5 to 8 bits)
LADDER = (32, 45, 64, 91, 128, 181, 256)
# the Telemetry hooks the Server calls (event() is the shared internal
# path of cow_fork and preempt, so it is not wrapped); now() is not a hook
TEL_HOOKS = ("submit", "admit", "prefill_chunk", "first_token", "emission",
             "decode_step", "spec_verify", "cow_fork", "preempt", "retire",
             "step_snapshot")
HOOK_LIMIT = 0.03              # hook time / step() wall, the reference's
# qwen2-moe-a2.7b's routed experts at the paged decode: 60 padded to 64,
# capacity 8 (T = 4 tokens); (name, K, N, launches per layer)
MOE_EXPERTS, MOE_CAPACITY = 64, 8
MOE_MVMS = [("e_gate+e_up", 2048, 1408, 2), ("e_down", 1408, 2048, 1)]
# deepseek-v3's routed experts at the slot decode (and at a prefill of up
# to 96 tokens): 256 experts of capacity 8
DS_EXPERTS, DS_CAPACITY = 256, 8
DS_MVMS = [("e_gate+e_up", 7168, 2048, 2), ("e_down", 2048, 7168, 1)]
DS_NEW_TOKENS = 8              # per request in phase 3d's serves
# new tokens per request in the 8-request serves: phases 3, 3p, 4b and 3l
# serve SERVE_NEW_TOKENS; the repeated serves of phases 3s, 3m and 3r serve
# SHORT_NEW_TOKENS (16 up to phase 3f, cut to keep the script's time)
SERVE_NEW_TOKENS, SHORT_NEW_TOKENS = 16, 8
# phase 3m(e)'s depth cuts, to keep the script's time (full width kept)
E_DEPTH = {"llama3-8b": 4, "granite-3-8b": 4}
# whisper-large-v3: its published text context (arXiv:2212.04356) and the
# greedy decode steps after each prefill of phase 3w
W_MAX_SEQ, W_STEPS = 448, 4   # 8 steps cut to 4 to keep the script's time
# phase 3w's kernels-vs-plain runs hold the kernels at the encoder's shapes
# over its first W_PLAIN_ENC layers (of 32), to keep the script's time
W_PLAIN_ENC = 4
# phase 3m's paged steps kernels vs plain run qwen2-moe's first
# M_PLAIN_LAYERS layers (of 24), to keep the script's time; its serves
# stay at full depth
M_PLAIN_LAYERS = 4
DRYRUN_LIMIT_S = 40.0          # phase "dryrun"'s time limit
# the reference's CI dry-run cells: (arch, shape, mesh, cim, ep, status)
DRYRUN_CELLS = (
    ("internlm2-1.8b", "decode_32k", "multi", "off", None, "ok"),
    ("internlm2-1.8b", "train_4k", "single", "off", None, "ok"),
    ("llama3-8b", "long_500k", "single", "off", None, "skipped"),
    ("internlm2-1.8b", "decode_32k", "single", "bp-prequant", None, "ok"),
    ("qwen2-moe-a2.7b", "decode_32k", "host", "bp-prequant", "a2a", "ok"))


# the phase clock: a line that starts "phase <name>" whose name differs
# from the last one's starts that phase; each phase gets the seconds up to
# the next one's start (summed where a phase's lines come back)
_CLOCK = {"t0": time.monotonic(), "phase": "start", "at": 0.0, "secs": {}}


def log(msg: str) -> None:
    m = re.match(r"phase (\w+)", msg)
    if m and m.group(1) != _CLOCK["phase"]:
        now = time.monotonic() - _CLOCK["t0"]
        secs = _CLOCK["secs"]
        secs[_CLOCK["phase"]] = round(secs.get(_CLOCK["phase"], 0.0)
                                      + now - _CLOCK["at"], 1)
        _CLOCK.update(phase=m.group(1), at=now)
    print(msg, flush=True)


def clock_line() -> str:
    """Every phase's seconds so far, and the script's."""
    now = time.monotonic() - _CLOCK["t0"]
    secs = dict(_CLOCK["secs"])
    secs[_CLOCK["phase"]] = round(secs.get(_CLOCK["phase"], 0.0) + now
                                  - _CLOCK["at"], 1)
    return (f"clock: {now:.1f} s since the script started; by phase, from "
            f"its first line to the next phase's: {json.dumps(secs)}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def time_ms(torch, fn, arg_sets, reps: int = 5, min_iters: int = 10) -> float:
    """Median over `reps` of the mean time of one call, CUDA events around
    a run that cycles through `arg_sets` (distinct buffers, so weights come
    from device memory and not from the 50 MB L2)."""
    n = max(len(arg_sets), min_iters)
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def graph_ms(torch, fn, arg_sets, reps: int = 5, min_iters: int = 10) -> float:
    """Device time of one call: the calls (cycling through `arg_sets`)
    captured once into a CUDA graph, CUDA events around its replays. The
    Python wrappers' host time drops out; what is left is the card's."""
    n = max(len(arg_sets), min_iters)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the default stream
        for a in arg_sets[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def copies(t, min_total: int = 128 << 20):
    """Enough clones of `t` to exceed the L2 cache when cycled."""
    n = max(1, math.ceil(min_total / (t.numel() * t.element_size())))
    return [t] + [t.clone() for _ in range(n - 1)]


# phase 3x: training; (a)'s depth and batch, (c)'s batch x seq and steps,
# (d)'s QAT steps
X_LAYERS, X_BATCH, X_SEQ = 2, 2, 64
X_FULL_BATCH, X_FULL_SEQ, X_FULL_STEPS = 2, 256, 4
X_QAT_STEPS = 40


def tree_equal(torch, a, b) -> bool:
    """Two trees of tensors (dicts, lists) equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(torch, a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(tree_equal(torch, x, y)
                                        for x, y in zip(a, b))
    if a.dtype.is_floating_point and a.element_size() == 2:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def phase_train(torch, np, dev, card: str) -> dict:
    """Phase 3x, training on the card (the module docstring); returns
    {"B2 per step": launches of one full-depth train step}."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.cim_matmul import CIMConfig, cim_matmul
    from repro_torch.data.tokens import SyntheticLMDataset
    from repro_torch.examples import train_cim_qat
    from repro_torch.kernels import build
    from repro_torch.launch import train as launch_train
    from repro_torch.models import registry
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime import trainer as trainer_mod

    t3x = time.monotonic()
    base = ARCHS["internlm2-1.8b"]
    bp = CIMConfig(enabled=True)
    plain = dataclasses.replace(bp, backend="plain")

    # (a) one train step at full width, X_LAYERS layers (the full vocab
    # head kept), kernels vs plain versions
    cfg = base.replace(n_layers=X_LAYERS, cim=bp)
    tc = TrainConfig(steps=100, lr=3e-4)
    params = registry.init_params(cfg, seed=0, device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLMDataset(
        cfg.vocab, X_SEQ, X_BATCH, seed=0).batch(0).items()}
    out = {}
    for tag, c in (("kernels", cfg), ("plain", cfg.replace(cim=plain))):
        step, opt = trainer_mod.make_train_step(c, tc)

        def loss_fn(p, b, c=c):
            return registry.train_loss(p, b, c)

        build.reset_launch_counts()
        loss, grads = trainer_mod.value_and_grad(loss_fn, params, batch)
        torch.cuda.synchronize()
        n_grad = build.launch_counts()["cim_mvm_grouped"]
        state = {"params": params, "opt": opt.init(params)}
        build.reset_launch_counts()
        t0 = time.monotonic()
        new_state, metrics = step(state, batch)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        n_step = build.launch_counts()["cim_mvm_grouped"]
        out[tag] = (loss, grads, new_state, metrics)
        log(f"phase 3x (a): {tag}: loss {float(loss):.6f}, one train step "
            f"{dt * 1e3:.1f} ms; B2 launches: {n_grad} in the loss and its "
            f"gradients, {n_step} in the step")
        if tag == "kernels":
            want = 2 * 7 * X_LAYERS + 1
            check(n_grad == want and n_step == want,
                  f"phase 3x (a): B2 launched {n_grad} / {n_step} times, "
                  f"expected {want} (7 a layer, twice under remat, + head)")
        else:
            check(n_grad == 0 and n_step == 0,
                  "phase 3x (a): the plain step launched B2")
        del state, new_state
    (lk, gk, sk, mk), (lp, gp, sp, mp) = out["kernels"], out["plain"]
    max_dg = max((a.float() - b.float()).abs().max().item()
                 for a, b in zip(tree_leaves(gk), tree_leaves(gp)))
    log(f"phase 3x (a): {cfg.arch} x {X_LAYERS} layers at full width, batch "
        f"{X_BATCH} x seq {X_SEQ}, --cim bp, AdamW: kernels vs plain "
        f"versions: loss equal {torch.equal(lk, lp)}, max |dgrad| {max_dg}, "
        f"updated params / m / v identical {tree_equal(torch, sk, sp)} "
        f"(tolerance 0)")
    check(torch.equal(lk, lp) and tree_equal(torch, gk, gp)
          and tree_equal(torch, sk, sp)
          and torch.equal(mk["grad_norm"], mp["grad_norm"]),
          "phase 3x (a): the kernel and plain train steps differ")
    del out, gk, gp, sk, sp, params
    torch.cuda.empty_cache()
    log(f"phase 3x (a): {time.monotonic() - t3x:.1f} s")

    # (b) cim_matmul's gradient through _EinsumVJP on the card: kernels
    # (B2) vs plain versions at a layer's shapes
    rng = np.random.RandomState(5)
    worst = 0.0
    for k, n in ((2048, 2048), (2048, 8192)):
        xs = torch.from_numpy(rng.randn(64, k).astype(np.float32)).to(dev)
        ws = torch.from_numpy((rng.randn(k, n) * 0.02).astype(
            np.float32)).to(dev)
        cs = torch.from_numpy(rng.randn(64, n).astype(np.float32)).to(dev)
        res = []
        for c in (bp, plain):
            x1 = xs.clone().requires_grad_()
            w1 = ws.clone().requires_grad_()
            build.reset_launch_counts()
            y = cim_matmul(x1, w1, c)
            check(y.grad_fn is not None, "phase 3x (b): the kernel output "
                  "came back detached")
            (y * cs).sum().backward()
            torch.cuda.synchronize()
            res.append((y.detach(), x1.grad, w1.grad,
                        build.launch_counts()["cim_mvm_grouped"]))
        (yk, gxk, gwk, nk), (yp, gxp, gwp, npl) = res
        check(nk == 1 and npl == 0, f"phase 3x (b): B2 launched {nk} times "
              "(a backward must launch none)")
        worst = max(worst, (gxk - gxp).abs().max().item(),
                    (gwk - gwp).abs().max().item())
        check(torch.equal(yk, yp) and torch.equal(gxk, gxp)
              and torch.equal(gwk, gwp), f"phase 3x (b): cim_matmul's "
              f"gradients differ kernels vs plain at K={k} N={n}")
    log(f"phase 3x (b): cim_matmul gradients through the einsum VJP, B2 vs "
        f"plain at M 64, K 2048, N in {{2048, 8192}}: max |dgrad| {worst} "
        f"(tolerance 0), one B2 launch per forward and none in the backward")

    # (c) the full model through launch.train's code path
    args = launch_train.parser().parse_args([
        "--arch", "internlm2-1.8b", "--cim", "bp", "--batch",
        str(X_FULL_BATCH), "--seq", str(X_FULL_SEQ), "--steps",
        str(X_FULL_STEPS), "--ckpt", str(ROOT / "build" / "train_ckpt"),
        "--device", dev.type])
    tr = launch_train.build(args)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    state = tr.init_state()
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    log(f"phase 3x (c): {tr.cfg.arch} ({tr.cfg.n_layers} layers, d_model "
        f"{tr.cfg.d_model}, d_ff {tr.cfg.d_ff}, vocab {tr.cfg.vocab}; "
        f"{n_params / 1e9:.3f} G params in bf16, AdamW m / v in f32) "
        f"initialised in {time.monotonic() - t0:.1f} s")
    losses, times, counts = [], [], []
    saved = peak = None
    t0_steps = time.monotonic()
    for i in range(X_FULL_STEPS):
        if i == 2:
            # the saved state both 2-step runs start from, held on the
            # card: a step writes new tensors and never its input state
            saved = state
            peak = torch.cuda.max_memory_allocated() / 2**30
        b = tr.batch(i)
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, metrics = tr.step_fn(state, b)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        counts.append(build.launch_counts()["cim_mvm_grouped"])
        losses.append(loss)
    want = 2 * 7 * tr.cfg.n_layers + 1
    log(f"phase 3x (c) ({card}): {X_FULL_STEPS} train steps, batch "
        f"{X_FULL_BATCH} x seq {X_FULL_SEQ}, --cim bp: losses {losses}; "
        f"step times {[round(t * 1e3, 1) for t in times]} ms; B2 launches "
        f"per step {counts}; peak {peak:.2f} GiB over steps 0-1 "
        f"({torch.cuda.max_memory_allocated() / 2**30:.2f} with the saved "
        f"state held)")
    check(all(math.isfinite(v) for v in losses), "phase 3x (c): loss not "
          "finite")
    check(all(c == want for c in counts), f"phase 3x (c): B2 launched "
          f"{counts} times a step, expected {want}")
    first_params = state["params"]
    del state
    again, state = [], saved
    for i in range(2, X_FULL_STEPS):
        state, metrics = tr.step_fn(state, tr.batch(i))
        again.append(float(metrics["loss"]))
    same = again == losses[2:] and tree_equal(torch, state["params"],
                                              first_params)
    log(f"phase 3x (c): two runs of steps 2-{X_FULL_STEPS - 1} from one "
        f"saved state: losses {losses[2:]} and {again}, parameters "
        f"identical: {same}; {time.monotonic() - t0_steps:.1f} s for the "
        f"{X_FULL_STEPS + X_FULL_STEPS - 2} steps")
    check(same, "phase 3x (c): two runs from one saved state differ")
    del saved, first_params
    # where a step's time goes: kernel time (profiler) against the wall
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = tr.step_fn(state, tr.batch(X_FULL_STEPS))
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = sorted((e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")),
                  key=dev_us, reverse=True)
    total_us = sum(dev_us(e) for e in rows)
    wall = statistics.median(times[1:])
    if total_us <= 0:
        log("phase 3x (c): profiler recorded no device time (idle share "
            "not measured)")
    else:
        log(f"phase 3x (c) ({card}): one train step: {total_us / 1e3:.1f} "
            f"ms of kernel time in {sum(e.count for e in rows)} launches "
            f"against a median step of {wall * 1e3:.1f} ms -> the card is "
            f"idle {100 * (1 - total_us / 1e6 / wall):.1f} % of the step")
        for e in rows[:10]:
            log(f"  profile: {dev_us(e) / 1e3:9.3f} ms "
                f"{100 * dev_us(e) / total_us:5.1f} %  x{e.count:<6d} "
                f"{e.key[:90]}")
    del state, tr
    torch.cuda.empty_cache()

    # (d) the QAT example, shortened: float vs --cim bp
    t0 = time.monotonic()
    qat = train_cim_qat.run(argparse.Namespace(
        steps=X_QAT_STEPS, batch=8, seq=64, arch="llama3-8b",
        device=dev.type),
        log=lambda m: log(f"phase 3x (d): {m}"))
    gap = qat["cim_bp"][-1] - qat["float"][-1]
    log(f"phase 3x (d): train_cim_qat, {X_QAT_STEPS} steps each: "
        f"final-loss gap (CIM-QAT - float) {gap:+.4f} nats in "
        f"{time.monotonic() - t0:.1f} s")
    check(all(math.isfinite(v) for v in qat["float"] + qat["cim_bp"]),
          "phase 3x (d): a QAT loss is not finite")
    log(f"phase 3x: {time.monotonic() - t3x:.1f} s in all")
    return {"B2 per step": counts[-1]}


# phase 3y: the A10b training legs. (a) qwen2-moe-a2.7b at full width:
# batch x seq of its steps (T = 512 tokens: capacity 40), the depth of the
# kernels-vs-plain step and of the Trainer's, the Trainer's steps; (b) the
# other legs: (arch, n_layers, batch, seq, optimizer)
Y_BATCH, Y_SEQ = 2, 256
Y_PARITY_LAYERS, Y_LAYERS, Y_STEPS = 1, 2, 3
Y_LEGS = (("deepseek-v3-671b", 3, 1, 64, "adafactor"),
          ("rwkv6-7b", 2, 2, 64, "adamw"),
          ("zamba2-2.7b", 6, 2, 64, "adamw"),
          ("whisper-large-v3", 2, 2, 64, "adamw"),
          ("internvl2-26b", 1, 1, 384, "adamw"))
# qwen2-moe's routed experts and dense MVMs in a train step: (label, K, N,
# launches per layer forward)
Y_EXPERT_MVMS = [("e_gate+e_up", 2048, 1408, 2), ("e_down", 1408, 2048, 1)]
Y_DENSE_MVMS = [("wq+wk+wv+wo", 2048, 2048, 4), ("w_gate+w_up", 2048, 5632, 2),
                ("w_down", 5632, 2048, 1)]


def stated_width(fn, *lead, bits: int = 4):
    """`fn` (B2e / B5e or a plain version) with `lead` arguments after its
    operands and, for a kernel (bits > 0), the codes' width stated as
    `ops` states the MacroConfig's: the launch then takes the tensor-core
    body, where a direct call that states none takes the dense kernel's."""
    def call(x, w, *args, **kw):
        return fn(x, w, *lead, *args, **kw,
                  **({"code_bits": bits} if bits else {}))
    call.__name__ = fn.__name__
    return call


def _mvm_time(torch, kern, plain, x, w, kw):
    """(kernel ms, plain ms, the kernel's max |diff| from its plain
    version) of one MVM at these operands; bit-exact or the run fails."""
    y, yp = kern(x, w, **kw), plain(x, w, **kw)
    torch.cuda.synchronize()
    check(torch.equal(y, yp), f"{kern.__name__} differs from its plain "
          f"version at x {tuple(x.shape)}, w {tuple(w.shape)}")
    args = [(x, wi) for wi in copies(w)]
    t_k = graph_ms(torch, lambda a, b: kern(a, b, **kw), args)
    t_p = graph_ms(torch, lambda a, b: plain(a, b, **kw), args[:2], reps=3,
                   min_iters=2)
    return t_k, t_p, (y - yp).abs().max().item()


def phase_train_legs(torch, np, dev, card: str) -> dict:
    """Phase 3y, the training legs of ROADMAP A10b on the card (the module
    docstring); returns {"B2e per step", "B2 per step"} of qwen2-moe's
    Trainer step."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.kernels import build
    from repro_torch.kernels import cim_mvm as cm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import registry
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime import trainer as trainer_mod

    t3y = time.monotonic()
    bp = CIMConfig(enabled=True)
    plain = dataclasses.replace(bp, backend="plain")
    kw = dict(n_rows=144, levels=362, gain=1.0, full_scale=32400.0)
    base = ARCHS["qwen2-moe-a2.7b"]
    shape = ShapeConfig("train", Y_SEQ, Y_BATCH, "train")
    n_exp = moe_mod.padded_experts(base.moe.n_experts)
    cap = moe_mod._capacity(Y_BATCH * Y_SEQ, base)
    rng = np.random.default_rng(25)

    def codes(shape_):
        return torch.from_numpy(rng.integers(0, 16, size=shape_,
                                             dtype=np.uint8)).to(dev).float()

    # (0) B2e and B5e (NOISY, seed 7) at the train step's capacity and B2
    # at its M = T, one MoE layer's forward MVMs each: bit-exact vs plain,
    # timed against bounds (B5e's: the counter hash). B2e and B5e share
    # their operands, drawn on the card (0.74 GB of f32 codes a projection)
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    nkw = dict(kw, sigma=0.277)
    cgen = torch.Generator(device=dev).manual_seed(25)
    expert_ops = {}

    def operands(kid, label, k, n, lead):
        if kid == "B2":
            return codes(lead + (k,)), codes((k, n))
        if label not in expert_ops:
            expert_ops[label] = tuple(
                torch.randint(0, 16, sh, generator=cgen, device=dev,
                              dtype=torch.float32)
                for sh in (lead + (k,), (n_exp, k, n)))
        return expert_ops[label] if kid == "B2e" \
            else expert_ops.pop(label)

    for kid, kern, plain_fn, mvms, lead, mkw in (
            ("B2e", stated_width(cm.cim_mvm_grouped_experts),
             cm.cim_mvm_grouped_experts_plain, Y_EXPERT_MVMS, (n_exp, cap),
             kw),
            ("B5e", stated_width(cm.cim_mvm_grouped_noisy_experts, seed),
             stated_width(cm.cim_mvm_grouped_noisy_experts_plain, seed,
                          bits=0),
             Y_EXPERT_MVMS, (n_exp, cap), nkw),
            ("B2", cm.cim_mvm_grouped, cm.cim_mvm_grouped_plain,
             Y_DENSE_MVMS, (Y_BATCH * Y_SEQ,), kw)):
        t_kid = time.monotonic()
        tot = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0,
               "hash_ops": 0.0, "err": 0.0}
        for label, k, n, count in mvms:
            x, w = operands(kid, label, k, n, lead)
            t_k, t_p, e = _mvm_time(torch, kern, plain_fn, x, w, mkw)
            rows = x.numel() // k
            wbytes = w.numel() * 4
            log(f"  phase 3y (0): {kid} {label:12s} x {tuple(x.shape)} w "
                f"{tuple(w.shape)} x{count}/layer: kernel {t_k * 1e3:.2f} "
                f"us ({wbytes / (t_k * 1e-3) / 1e12:.3f} TB/s of "
                f"{wbytes / 1e6:.1f} MB codes), plain {t_p * 1e3:.2f} us")
            tot["ms"] += count * t_k
            tot["plain_ms"] += count * t_p
            tot["bytes"] += count * (wbytes + rows * (k + n) * 4)
            tot["ops"] += count * 2 * rows * k * n
            if kid == "B5e":
                tot["hash_ops"] += count * rows * n * (
                    -(-k // kw["n_rows"]) * HASH_OPS_PER_CONVERSION
                    + HASH_OPS_PER_OUTPUT)
            tot["err"] = max(tot["err"], e)
            del x, w
            torch.cuda.empty_cache()
        b_bytes = tot["bytes"] / HBM_BYTES_S * 1e3
        b_ops = max(tot["ops"] / INT_OP_S,
                    tot["hash_ops"] / INT32_OP_S) * 1e3
        log(f"phase 3y (0) ({card}): {kid} bit-exact vs plain (max |diff| "
            f"{tot['err']}); one "
            f"qwen2-moe layer's forward at {'M' if kid == 'B2' else 'C'} "
            f"= {lead[-1]}: kernel {tot['ms']:.3f} ms, plain "
            f"{tot['plain_ms']:.3f} ms, bound {max(b_bytes, b_ops):.3f} ms "
            f"(bytes {b_bytes:.3f}, operations {b_ops:.3f}"
            + (f", hash {tot['hash_ops'] / 1e9:.2f} G int32 ops"
               if tot["hash_ops"] else "")
            + f"); {time.monotonic() - t_kid:.1f} s")

    # (a) one train step at full width, Y_PARITY_LAYERS layer(s), kernels
    # vs plain versions: loss, gradients, grad norm, params, m and v
    t0 = time.monotonic()
    cfg = base.replace(n_layers=Y_PARITY_LAYERS, cim=bp)
    tc = TrainConfig(steps=100, lr=3e-4)
    params = registry.init_params(cfg, seed=0, device=dev)
    batch = synthetic_batch(cfg, shape, device=dev)
    out = {}
    want = {"cim_mvm_grouped_experts": 3 * 2 * Y_PARITY_LAYERS,
            "cim_mvm_grouped": 7 * 2 * Y_PARITY_LAYERS + 1}
    for tag, c in (("kernels", cfg), ("plain", cfg.replace(cim=plain))):
        step, opt = trainer_mod.make_train_step(c, tc)
        build.reset_launch_counts()
        loss, grads = trainer_mod.value_and_grad(
            lambda p, b, c=c: registry.train_loss(p, b, c), params, batch)
        torch.cuda.synchronize()
        n_grad = {k_: build.launch_counts()[k_] for k_ in want}
        build.reset_launch_counts()
        new_state, metrics = step({"params": params,
                                   "opt": opt.init(params)}, batch)
        torch.cuda.synchronize()
        n_step = {k_: build.launch_counts()[k_] for k_ in want}
        out[tag] = (loss, grads, new_state, metrics)
        log(f"phase 3y (a): {tag}: loss {float(loss):.6f}; launches in the "
            f"loss and its gradients {n_grad}, in the step {n_step}")
        expect = want if tag == "kernels" else {k_: 0 for k_ in want}
        check(n_grad == expect and n_step == expect,
              f"phase 3y (a): {tag} launches {n_grad} / {n_step}, expected "
              f"{expect} (B2e 3 a MoE layer, B2 7 a layer, twice under "
              "remat, + the head)")
        del loss, grads, new_state, metrics
    (lk, gk, sk, mk), (lp, gp, sp, mp) = out["kernels"], out["plain"]
    max_dg = max((a.float() - b.float()).abs().max().item()
                 for a, b in zip(tree_leaves(gk), tree_leaves(gp)))
    same = torch.equal(lk, lp) and tree_equal(torch, gk, gp) \
        and tree_equal(torch, sk, sp) \
        and torch.equal(mk["grad_norm"], mp["grad_norm"])
    log(f"phase 3y (a): {cfg.arch} x {Y_PARITY_LAYERS} layer at full width "
        f"({cfg.moe.n_experts} routed experts padded to {n_exp}, capacity "
        f"{cap}, top-"
        f"{cfg.moe.top_k}; shared expert {cfg.moe.d_ff_shared}), batch "
        f"{Y_BATCH} x seq {Y_SEQ}, --cim bp, AdamW: kernels vs plain: loss "
        f"equal {torch.equal(lk, lp)}, max |dgrad| {max_dg}, params / m / v "
        f"identical {tree_equal(torch, sk, sp)} (tolerance 0); "
        f"{time.monotonic() - t0:.1f} s")
    check(same and math.isfinite(float(mk["grad_norm"])),
          "phase 3y (a): the kernel and plain train steps differ")
    del out, gk, gp, sk, sp, params
    torch.cuda.empty_cache()

    # (a) Y_LAYERS layers through the Trainer: Y_STEPS steps, then steps
    # 1 .. Y_STEPS - 1 again from the state held before step 1
    cfg = base.replace(n_layers=Y_LAYERS, cim=bp)
    tr = trainer_mod.Trainer(cfg, shape, TrainConfig(steps=Y_STEPS,
                                                     lr=3e-4),
                             str(ROOT / "build" / "train_moe_ckpt"),
                             device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    state = tr.init_state()
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    log(f"phase 3y (a): {cfg.arch} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}; {n_params / 1e9:.3f} G params "
        f"in bf16, AdamW m / v in f32) initialised in "
        f"{time.monotonic() - t0:.1f} s")
    losses, times, counts = [], [], []
    saved = peak = None
    for i in range(Y_STEPS):
        if i == 1:
            saved = state
            peak = torch.cuda.max_memory_allocated() / 2**30
        b = tr.batch(i)
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, metrics = tr.step_fn(state, b)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        lc = build.launch_counts()
        counts.append((lc["cim_mvm_grouped_experts"], lc["cim_mvm_grouped"]))
    want_step = (3 * 2 * Y_LAYERS, 7 * 2 * Y_LAYERS + 1)
    log(f"phase 3y (a) ({card}): {Y_STEPS} Trainer steps, batch {Y_BATCH} x "
        f"seq {Y_SEQ}, --cim bp: losses {losses}; step times "
        f"{[round(t * 1e3, 1) for t in times]} ms; (B2e, B2) launches per "
        f"step {counts}; peak {peak:.2f} GiB over step 0 "
        f"({torch.cuda.max_memory_allocated() / 2**30:.2f} with the saved "
        f"state held)")
    check(all(math.isfinite(v) for v in losses), "phase 3y (a): loss not "
          "finite")
    check(all(c == want_step for c in counts), f"phase 3y (a): launches "
          f"{counts} a step, expected {want_step}")
    first_params = state["params"]
    del state
    again, state = [], saved
    for i in range(1, Y_STEPS):
        state, metrics = tr.step_fn(state, tr.batch(i))
        again.append(float(metrics["loss"]))
    same = again == losses[1:] and tree_equal(torch, state["params"],
                                              first_params)
    log(f"phase 3y (a): two runs of steps 1-{Y_STEPS - 1} from one saved "
        f"state: losses {losses[1:]} and {again}, parameters identical: "
        f"{same}")
    check(same, "phase 3y (a): two runs from one saved state differ")
    del saved, first_params
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = tr.step_fn(state, tr.batch(Y_STEPS))
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = sorted((e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")),
                  key=dev_us, reverse=True)
    total_us = sum(dev_us(e) for e in rows)
    wall = statistics.median(times[1:])
    if total_us <= 0:
        log("phase 3y (a): profiler recorded no device time (idle share "
            "not measured)")
    else:
        log(f"phase 3y (a) ({card}): one train step: {total_us / 1e3:.1f} "
            f"ms of kernel time in {sum(e.count for e in rows)} launches "
            f"against a median step of {wall * 1e3:.1f} ms -> the card is "
            f"idle {100 * (1 - total_us / 1e6 / wall):.1f} % of the step")
        for e in rows[:12]:
            log(f"  profile: {dev_us(e) / 1e3:9.3f} ms "
                f"{100 * dev_us(e) / total_us:5.1f} %  x{e.count:<6d} "
                f"{e.key[:90]}")
    del state, tr
    torch.cuda.empty_cache()

    # (b) the other legs: one step each at full width, its depth cut,
    # kernels vs plain versions
    for arch, depth, bsz, seq, opt_name in Y_LEGS:
        t0 = time.monotonic()
        torch.cuda.reset_peak_memory_stats()
        lcfg = ARCHS[arch].replace(n_layers=depth, cim=bp)
        if lcfg.encoder_layers:
            lcfg = lcfg.replace(encoder_layers=depth)
        lshape = ShapeConfig("train", seq, bsz, "train")
        ltc = TrainConfig(steps=100, lr=3e-4, optimizer=opt_name)
        params = registry.init_params(lcfg, seed=0, device=dev,
                                      max_seq=seq + 8)
        batch = synthetic_batch(lcfg, lshape, device=dev)
        res = []
        for c in (lcfg, lcfg.replace(cim=plain)):
            step, opt = trainer_mod.make_train_step(c, ltc)
            build.reset_launch_counts()
            new_state, m = step({"params": params, "opt": opt.init(params)},
                                batch)
            torch.cuda.synchronize()
            res.append((new_state, m, {k_: v for k_, v in
                                       build.launch_counts().items() if v}))
            del new_state
        (sk, mk, ck), (sp, mp, cp) = res
        n_params = sum(t.numel() for t in tree_leaves(params))
        same = torch.equal(mk["loss"], mp["loss"]) \
            and torch.equal(mk["grad_norm"], mp["grad_norm"]) \
            and tree_equal(torch, sk, sp)
        log(f"phase 3y (b) ({card}): {arch} x {depth} layers"
            + (f" (+ {depth} encoder layers over {lcfg.encoder_len} frames)"
               if lcfg.encoder_layers else "")
            + f" at full width ({n_params / 1e9:.3f} G params), batch {bsz} "
            f"x seq {seq}, --cim bp, {opt_name}: loss {float(mk['loss']):.6f}"
            f", kernels vs plain identical {same} (loss, grad norm, params, "
            f"optimizer state; tolerance 0); launches {ck} (plain {cp}); "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"{time.monotonic() - t0:.1f} s")
        check(same, f"phase 3y (b): {arch}'s kernel and plain steps differ")
        check(ck.get("cim_mvm_grouped", 0) > 0 and not cp,
              f"phase 3y (b): {arch}: launches {ck} / plain {cp}")
        check(math.isfinite(float(mk["loss"]))
              and math.isfinite(float(mk["grad_norm"])),
              f"phase 3y (b): {arch}'s loss or gradient is not finite")
        del res, sk, sp, params, batch
        torch.cuda.empty_cache()
    log(f"phase 3y: {time.monotonic() - t3y:.1f} s in all")
    return {"B2e per step": counts[-1][0], "B2 per step": counts[-1][1]}


# phase 3f: Fig. 10's ADC ladder and the figures' B2 shapes (x [M, K] x
# w [K, N]): the classifier's two layers, quickstart's matmul
F_LADDER = (32, 64, 128, 256, 362, 512, 1024)
F_SHAPES = [(1024, 64, 144), (1024, 144, 16), (8, 288, 16)]
F_ROWS = 74                    # the reference's figure rows
F_KW = dict(n_rows=144, levels=362, gain=1.0, full_scale=32400.0)


def f_operands(torch, np, dev):
    """[((M, K, N), x, w)]: codes at phase 3f's B2 shapes, seed 26."""
    rng = np.random.default_rng(26)
    out = []
    for m, k, n in F_SHAPES:
        x = torch.from_numpy(rng.integers(0, 16, (m, k)).astype(
            np.float32)).to(dev)
        w = torch.from_numpy(rng.integers(0, 16, (k, n)).astype(
            np.float32)).to(dev)
        out.append(((m, k, n), x, w))
    return out


def _fmt_us(us) -> str:
    return "not measured" if us is None else f"{us:.2f} us a call"


def b2_bodies(torch, np, dev, calls: int = 20) -> dict:
    """{shape: B2's own device time per call at L 362 in us, or None}:
    torch.profiler's CUPTI rows over `calls` eager calls at each of phase
    3f's shapes. Read right after phase 2: at the end of the script the
    profiler records no kernel rows for these calls (unexplained). What a
    graph replay takes beyond the body lies between the kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import cim_mvm as cm
    out = {}
    for shape, x, w in f_operands(torch, np, dev):
        cm.cim_mvm_grouped(x, w, **F_KW)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                cm.cim_mvm_grouped(x, w, **F_KW)
            torch.cuda.synchronize()
        rows_ = [e for e in prof.key_averages()
                 if "cim_mvm_dense_kernel" in e.key]
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in rows_)
        n_ = sum(e.count for e in rows_)
        out[shape] = us / n_ if us > 0 and n_ == calls else None
    return out


def phase_figures(torch, np, dev, card: str, bodies: dict) -> dict:
    """Phase 3f, the paper's figures and the examples on the card (the
    module docstring); `bodies` is b2_bodies' reading. Returns the B2, B3
    and decode launches of (a) and (c)."""
    import contextlib
    import io
    import types

    from repro_torch.core import PROTOTYPE
    from repro_torch.core.energy import mvm_energy
    from repro_torch.core.macro import OperatingPoint
    from repro_torch.examples import quickstart, serve_decode, sqnr_study
    from repro_torch.figures import run as fig_run
    from repro_torch.kernels import build
    from repro_torch.kernels import cim_mvm as cm
    from repro_torch.runtime.server import _splice as splice

    t3f = time.monotonic()
    kinds = {"B2": "cim_mvm_grouped", "B3": "paged_attn_call",
             "B4": "decode_write_attend_call"}
    launched = dict.fromkeys(kinds, 0)

    def take(tag: str, want: dict) -> dict:
        """This part's launches (the counts were reset before it), checked
        against `want` ({kernel id: count, or None for "at least one"}),
        every other kernel 0."""
        counts = build.launch_counts()
        got = {kid: counts[name] for kid, name in kinds.items()}
        for kid, n in want.items():
            check(got[kid] > 0 if n is None else got[kid] == n,
                  f"phase 3f: {tag}: {kid} launched {got[kid]} times, "
                  f"expected {'> 0' if n is None else n}")
        rest = sum(counts.values()) - sum(got[k] for k in want)
        check(rest == 0, f"phase 3f: {tag}: {rest} launches of kernels "
              f"other than {sorted(want)}: {counts}")
        for kid in want:
            launched[kid] += got[kid]
        return got

    # (a) the figures, through figures.run, each module timed
    secs = {}

    def timed(name, mod):
        def run(device=None):
            t0 = time.monotonic()
            try:
                return mod.run(device=device)
            finally:
                torch.cuda.synchronize()
                secs[name] = time.monotonic() - t0
        return types.SimpleNamespace(run=run)

    modules = list(fig_run.MODULES)
    fig_run.MODULES[:] = [(n, timed(n, m)) for n, m in modules]
    out = io.StringIO()
    build.reset_launch_counts()
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(out):
            fig_run.main(["--device", str(dev)])
    except SystemExit as e:
        check(False, f"phase 3f: figures.run exited {e.code}")
    finally:
        fig_run.MODULES[:] = modules
    t_fig = time.monotonic() - t0
    lines = out.getvalue().strip().splitlines()
    for ln in lines:
        log(f"phase 3f: {ln}")
    check(lines[0] == "name,us_per_call,derived" and len(lines) == F_ROWS + 1,
          f"phase 3f: figures.run printed {len(lines) - 1} rows, expected "
          f"{F_ROWS}")
    rows = {}
    for ln in lines[1:]:
        name, _, derived = ln.split(",", 2)
        check("ERROR" not in derived, f"phase 3f: {ln}")
        nums = [float(v) for v in re.findall(
            r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?", derived)]
        check(all(math.isfinite(v) for v in nums), f"phase 3f: not finite: "
              f"{ln}")
        rows[name] = derived
    sig_e = PROTOTYPE.sigma_e_lsb()
    topsw = {v: mvm_energy(dataclasses.replace(
        PROTOTYPE, op=OperatingPoint(vdd=v)), 144).tops_per_w
        for v in (0.65, 1.2)}
    check(abs(sig_e - 0.59) <= 0.59e-3 and "model=0.590" in
          rows["fig16b_total_sigma_e"], f"phase 3f: sigma_E {sig_e}, "
          "paper 0.59 LSB")
    for v, paper in ((0.65, 40.2), (1.2, 18.6)):
        check(abs(topsw[v] - paper) <= 0.01 * paper and
              f"TOPSW={paper}" in rows[f"fig21_vdd{v:g}"],
              f"phase 3f: {topsw[v]} TOPS/W at {v} V, paper {paper}")
    fig_launches = take("figures.run", {"B2": 16})
    log(f"phase 3f: (a) figures.run: {len(lines) - 1} rows in {t_fig:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in secs.items())}); anchors "
        f"sigma_E {sig_e:.4f} LSB, {topsw[0.65]:.2f} / {topsw[1.2]:.2f} "
        f"TOPS/W at 0.65 / 1.2 V; B2 {fig_launches['B2']} launches (one per "
        "IDEAL BP cim_matmul: fig1b 2, fig10 14), no other kernel")

    # (b) B2 at the figures' shapes and ladder, kernel vs plain, timed
    err, times = 0.0, {}
    for (m, k, n), x, w in f_operands(torch, np, dev):
        for levels in F_LADDER:
            kw = dict(n_rows=144, levels=levels, gain=1.0, full_scale=32400.0)
            y, yp = cm.cim_mvm_grouped(x, w, **kw), \
                cm.cim_mvm_grouped_plain(x, w, **kw)
            torch.cuda.synchronize()
            e = (y - yp).abs().max().item()
            check(torch.equal(y, yp), f"phase 3f: B2 differs from its plain "
                  f"version at x [{m}, {k}] x [{k}, {n}], L {levels}: {e}")
            err = max(err, e)
        t_k, t_p, _ = _mvm_time(torch, cm.cim_mvm_grouped,
                                cm.cim_mvm_grouped_plain, x, w, F_KW)
        bound = (m * k + k * n + m * n) * 4 / HBM_BYTES_S * 1e3
        times[(m, k, n)] = (t_k, t_p, bound)
        log(f"phase 3f: (b) B2 at x [{m}, {k}] x [{k}, {n}], L 362: "
            f"{t_k * 1e3:.2f} us on the card (CUDA graph), plain "
            f"{t_p * 1e3:.2f} us, bound {bound * 1e3:.3f} us (bytes; "
            f"{card}); kernel body {_fmt_us(bodies[(m, k, n)])} "
            "(profiler, after phase 2)")
    build.reset_launch_counts()
    log(f"phase 3f: (b) B2 bit-exact vs plain at {len(F_SHAPES)} shapes x L "
        f"in {F_LADDER} (max |err| {err})")

    # (c) the examples on the card; before each serve_decode serve, one
    # prefill and one decode step of its engine with the kernels and with
    # their plain versions, at the shapes the serve gives them
    def decode_steps(server, step_cfg):
        """serve_decode's model (3 slots, max_len 96): one prefill and one
        decode step of `server`'s engine (slots: a 19-token prompt spliced
        into slot 1, then all 3 slots; paged: a C = 8 chunk of 8 / 5 / 0
        tokens, then C = 1, blocks of 8); (the two logits, K and V)."""
        mod, n, max_len = server.mod, server.n_slots, server.max_len
        srng = np.random.RandomState(11)
        nxt = torch.from_numpy(srng.randint(0, step_cfg.vocab, (n, 1))).to(
            dev)
        if not server.paged:
            toks = torch.from_numpy(srng.randint(
                0, step_cfg.vocab, (1, 19))).to(dev)
            l1, rcache = mod.prefill(server.params, {"tokens": toks},
                                     step_cfg, max_len=max_len)
            cache = splice(mod.init_cache(step_cfg, n, max_len, device=dev),
                           rcache, 1)
            l2, cache = mod.decode_step(server.params, nxt, cache, step_cfg)
            return (l1, l2), cache["layers"]
        nb = max_len // 8
        cache = mod.init_paged_cache(step_cfg, n * nb + 1, 8, device=dev)
        tb = torch.arange(1, n * nb + 1, dtype=torch.int32,
                          device=dev).reshape(n, nb)
        toks = torch.from_numpy(srng.randint(0, step_cfg.vocab, (n, 8))).to(
            dev)
        valid = torch.tensor([8, 5, 0], device=dev)
        l1, cache = mod.paged_step(
            server.params, toks, cache, tb,
            torch.zeros(n, device=dev, dtype=torch.long), valid, step_cfg)
        l2, cache = mod.paged_step(server.params, nxt, cache, tb, valid,
                                   torch.tensor([1, 1, 0], device=dev),
                                   step_cfg)
        # the trash block (0) takes masked writes by design; the empty
        # slot's rows are not compared
        return (l1[:2], l2[:2]), {n_: cache["layers"][n_][:, 1:]
                                  for n_ in ("k", "v")}

    def check_decode_steps(server, tag, want):
        """The steps above with the kernels (launching each kernel of
        `want`) and with their plain versions (launching none): identical
        logits and K/V (tolerance 0). Not counted as the serve's launches."""
        build.reset_launch_counts()
        l_k, kv_k = decode_steps(server, server.cfg)
        torch.cuda.synchronize()
        k_counts = build.launch_counts()
        l_p, kv_p = decode_steps(server, server.cfg.replace(
            attn_backend="plain",
            cim=dataclasses.replace(server.cfg.cim, backend="plain")))
        torch.cuda.synchronize()
        p_counts = build.launch_counts()
        check(all(bool(torch.isfinite(a).all()) for a in l_k),
              f"phase 3f: {tag}: step logits not finite")
        d_err = max((a - b).abs().max().item() for a, b in zip(l_k, l_p))
        same = all(torch.equal(kv_k[n_], kv_p[n_]) for n_ in ("k", "v"))
        got = {kid: k_counts[kinds[kid]] for kid in want}
        log(f"phase 3f: (c) {tag}: prefill + decode step, kernels vs plain "
            f"versions: max |dlogit| = {d_err}, K/V identical: {same} "
            f"(tolerance 0); kernel launches {got}")
        check(d_err == 0.0 and same, f"phase 3f: {tag}: kernel and plain "
              "steps differ")
        check(all(n_ > 0 for n_ in got.values()), f"phase 3f: {tag}: the "
              f"kernel steps launched {got}, expected each > 0")
        check(p_counts == k_counts, f"phase 3f: {tag}: the plain steps "
              f"launched kernels: {p_counts} after {k_counts}")
        build.reset_launch_counts()

    for tag, fn, argv, want in (
            ("quickstart", quickstart.main, [], {"B2": 3}),
            ("sqnr_study", sqnr_study.main, [], {}),
            ("serve_decode --cim", serve_decode.main, ["--cim"],
             {"B2": None}),
            ("serve_decode --cim --paged", serve_decode.main,
             ["--cim", "--paged"], {"B2": None, "B3": None, "B4": None})):
        if tag.startswith("serve_decode"):
            check_decode_steps(serve_decode.make_server(
                True, "--paged" in argv, 3, dev), tag, want)
        build.reset_launch_counts()
        out = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            fn(argv + ["--device", str(dev)])
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        text = out.getvalue().strip().splitlines()
        for ln in text:
            if ln.strip():
                log(f"phase 3f: {tag}: {ln}")
        got = take(tag, want)
        if tag.startswith("serve_decode"):
            check(re.fullmatch(r"mode=CIM-BP: 48 tokens in \d+ batched "
                               r"decode steps, [\d.]+ tok/s", text[-1])
                  is not None, f"phase 3f: {tag}: {text[-1]}")
        if tag == "quickstart":
            check(text[-2] == "B2 kernel output: (8, 16), finite=True",
                  f"phase 3f: quickstart: {text[-2]}")
        log(f"phase 3f: (c) {tag}: {dt:.2f} s, launches B2 {got['B2']}, B3 "
            f"{got['B3']}, decode {got['B4']}")
    log(f"phase 3f: {time.monotonic() - t3f:.1f} s in all")
    return {"launches": launched, "times": times}


def phase_tune_mesh(torch, np, dev, card: str, ctx) -> None:
    """Phases "tune" and "mesh" at phase 3's width and settings (`ctx`:
    phase 3's float params, cfg, serving config and prompts, the MVM
    kernel keywords `kw`, the `codes` maker and main's serve helpers
    serve_mix, check_steps and short_serve). A script under build/
    can call it after `build.build_all()`."""
    import torch.distributed as dist

    from repro_torch.core.cim_matmul import (CIMConfig, cim_matmul_prequant,
                                             quantize_weight_offline)
    from repro_torch.core.macro import SimLevel
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import cim_mvm as cm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.mesh import make_host_smoke_mesh, make_mesh
    from repro_torch.parallel import sharding
    from repro_torch.parallel.collectives import compressed_psum
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.runtime.server import Server
    from repro_torch.runtime.telemetry import KERNEL_COUNTERS

    # ---- phase "tune": the kernel tuning cache on the main path ------------
    t_tune = time.monotonic()
    tune_entries, mvm_won = {}, False
    plat = autotune.platform_of(dev)
    step_ms = {"default": 0.0, "tuned": 0.0}
    for label, k, n, count in DECODE_MVMS:
        groups = -(-k // 144)
        x = ctx.codes((4, k))
        wp = ops.pack_codes(ctx.codes((k, n))).contiguous()
        default = cm.cim_mvm_grouped_packed(x, wp, **ctx.kw)
        check(torch.equal(default, cm.cim_mvm_grouped_packed_plain(
            x, wp, **ctx.kw)),
              f"phase tune: B1 differs from its plain version at {label}")
        args = [(x, wi) for wi in copies(wp)]
        rows = []
        for cand in autotune.mvm_candidates(groups):
            def run(a, b, cand=cand):
                return cm.cim_mvm_grouped_packed(a, b, **ctx.kw, **cand)
            check(torch.equal(run(x, wp), default), f"phase tune: B1 at "
                  f"{label} with {cand} differs from the default launch")
            rows.append((graph_ms(torch, run, args, reps=3), cand))
        t_def = rows[0][0]
        t_win, win = min(rows, key=lambda r: r[0])
        mvm_won |= win != rows[0][1]
        fam = autotune.mvm_family(4, groups, n)
        tune_entries[autotune.cache_key("cim_mvm", fam, "cuda_packed",
                                        plat)] = dict(
            win, us=t_win * 1e3, default_us=t_def * 1e3)
        step_ms["default"] += count * t_def
        step_ms["tuned"] += count * t_win
        log(f"phase tune ({card}): B1 {label} M=4 K={k} N={n} ({fam}), "
            f"bit-exact vs default and plain at every candidate; us by "
            f"(cluster, wcols), 0 = the launcher's choice: " + ", ".join(
                f"({c['cluster']}, {c['wcols']}) {t * 1e3:.2f}"
                for t, c in rows) + f" -> ({win['cluster']}, "
            f"{win['wcols']})")
        del x, wp, args, default
    log(f"phase tune ({card}): B1 over one decode step's 169 MVMs: default "
        f"{step_ms['default']:.3f} ms, tuned {step_ms['tuned']:.3f} ms")
    # B3 (and the decode launch, B4 folded in) at the decode window: dh
    # 128, bs 16, MB 16, bf16 pools, 4 slots
    b, kh, g, dh, bs, mb = 4, 8, 2, 128, 16, 16
    nb = b * mb + 1
    trng = np.random.RandomState(21)
    pools = [torch.from_numpy(trng.standard_normal((nb, bs, kh, dh))
                              .astype(np.float32)).to(dev).bfloat16()
             for _ in range(2)]
    for pool in pools:
        pool[0] = float("nan")
    tables = torch.from_numpy(trng.permutation(np.arange(1, nb)).astype(
        np.int32).reshape(b, mb)).to(dev)
    lens = torch.tensor([0, 37, 130, 224], dtype=torch.int32, device=dev)
    kvl = lens + torch.tensor([0, 1, 1, 1], dtype=torch.int32, device=dev)
    q = torch.from_numpy(trng.standard_normal((b, 1, kh * g, dh)).astype(
        np.float32)).to(dev).bfloat16()
    new = [torch.from_numpy(trng.standard_normal((b, 1, kh, dh)).astype(
        np.float32)).to(dev).bfloat16() for _ in range(2)]
    flat = (tables[:, 2].long() * bs + 5).to(torch.int32)
    flat[0] = 0
    pool_copies = [tuple(p.clone() for p in pools) for _ in range(8)]
    s_rows = []
    for cand in autotune.attn_candidates(mb):
        sp = cand["splits"]
        check(torch.equal(pa.paged_attn_call(q, *pools, tables, lens, kvl,
                                             splits=sp),
                          pa.paged_attn_plain(q, *pools, tables, lens, kvl,
                                              sp)),
              f"phase tune: B3 at S={sp} differs from its plain version")
        kp_k, vp_k = (p.clone() for p in pools)
        kp_p, vp_p = (p.clone() for p in pools)
        out_k = pa.decode_write_attend_call(q, kp_k, vp_k, *new, flat,
                                            tables, lens, kvl, splits=sp)
        out_p = pa.decode_write_attend_plain(q, kp_p, vp_p, *new, flat,
                                             tables, lens, kvl, sp)
        check(torch.equal(out_k, out_p) and tree_equal(
            torch, [kp_k, vp_k], [kp_p, vp_p]), f"phase tune: the decode "
            f"launch at S={sp} differs from B4 then B3 plain at S={sp}")

        def fused(kp, vp, sp=sp):
            return pa.decode_write_attend_call(q, kp, vp, *new, flat, tables,
                                               lens, kvl,
                                               out_dtype=torch.bfloat16,
                                               splits=sp)
        s_rows.append((graph_ms(torch, fused, pool_copies, reps=3), sp))
    t_s_def = s_rows[0][0]
    t_s_win, s_win = min(s_rows)
    tune_entries[autotune.cache_key("paged_attn",
                                    autotune.attn_family(mb * bs, 1),
                                    "kernel", plat)] = {
        "splits": s_win, "block_size": None, "us": t_s_win * 1e3,
        "default_us": t_s_def * 1e3}
    log(f"phase tune ({card}): the decode launch (B3 + B4, dh {dh}, bs "
        f"{bs}, MB {mb}, bf16), bit-exact vs plain at the same S for every "
        f"S; us by S: " + ", ".join(f"S={sp} {t * 1e3:.2f}"
                                    for t, sp in sorted(s_rows, key=lambda r:
                                                        r[1]))
        + f" -> S={s_win} (default {s_rows[0][1]})")
    del pools, pool_copies, q, new
    tune_dir = tempfile.mkdtemp(prefix="tune_")
    tune_path = os.path.join(tune_dir, "tune_cache.json")
    autotune.save_cache(tune_path, tune_entries)
    log(f"phase tune: {len(tune_entries)} winners written to the cache")
    # the phase-3 configuration served untuned, then under the cache
    short_mix = dict(new_tokens=SHORT_NEW_TOKENS)
    server = Server(ctx.params, ctx.cfg, ctx.serving, device=dev)
    counts_a, streams_a = ctx.serve_mix(server, ctx.prompts,
                                        "phase tune: untuned", **short_mix)
    del server
    os.environ[autotune.CACHE_ENV] = tune_path
    KERNEL_COUNTERS.reset()
    server = Server(ctx.params, ctx.cfg, ctx.serving, device=dev)
    counts_t, streams_t = ctx.serve_mix(server, ctx.prompts,
                                        "phase tune: --tune-cache",
                                        **short_mix)
    log(f"phase tune: tune_cache lookups of the tuned serve "
        f"{dict(KERNEL_COUNTERS.tune_cache)}")
    check(KERNEL_COUNTERS.tune_cache["cim_mvm:hit"] > 0
          and KERNEL_COUNTERS.tune_cache["paged_attn:hit"] > 0
          and not any(k.endswith("clamp")
                      for k in KERNEL_COUNTERS.tune_cache),
          "phase tune: the tuned serve did not hit the cache (or clamped)")
    check(counts_t == counts_a, "phase tune: the tuned serve launched "
          f"otherwise: {counts_t} vs {counts_a}")
    if s_win == s_rows[0][1]:
        check(streams_t == streams_a, "phase tune: only launch knobs won, "
              "but the tuned serve's streams differ from the untuned")
        log(f"phase tune: the default S won; tuned streams identical to "
            f"the untuned (MVM knobs {'won' if mvm_won else 'default'})")
    else:
        log(f"phase tune: S={s_win} won: streams "
            f"{'identical' if streams_t == streams_a else 'differ'} (a "
            "last-bit change may move a DAC code); its steps held kernels "
            "vs plain at that S instead")
        ctx.check_steps(server, "phase tune: at the tuned S")
    del server
    # a malformed cache: the defaults, one warning, one counted fallback
    bad_path = os.path.join(tune_dir, "malformed.json")
    with open(bad_path, "w") as f:
        f.write("{not json")
    os.environ[autotune.CACHE_ENV] = bad_path
    KERNEL_COUNTERS.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        server = Server(ctx.params, ctx.cfg, ctx.serving, device=dev)
        counts_b = ctx.short_serve(server, ctx.prompts,
                                   "phase tune: malformed cache")
    n_warn = sum("ignoring tune cache" in str(w.message) for w in caught)
    log(f"phase tune: malformed cache: {n_warn} warning(s), "
        f"{KERNEL_COUNTERS.fallback_warnings} counted fallback(s), "
        f"lookups {dict(KERNEL_COUNTERS.tune_cache)}")
    check(n_warn == 1 and KERNEL_COUNTERS.fallback_warnings == 1
          and counts_b["cim_mvm_grouped_packed"] > 0,
          "phase tune: a malformed cache must serve the defaults with one "
          "warning and one counted fallback")
    del server
    os.environ.pop(autotune.CACHE_ENV)
    shutil.rmtree(tune_dir)
    log(f"phase tune: {time.monotonic() - t_tune:.1f} s in all")

    # ---- phase "mesh": a 1-rank mesh (nccl) is no mesh, bit for bit -------
    t_mesh = time.monotonic()
    mesh, m_data, m_model = make_host_smoke_mesh()
    log(f"phase mesh: serving on host mesh data={m_data} model={m_model} "
        f"({dist.get_backend()}, world {dist.get_world_size()})")
    mrng = np.random.RandomState(31)
    for level in (SimLevel.IDEAL, SimLevel.NOISY):
        mcfg = CIMConfig(enabled=True, noise_seed=0, macro=dataclasses.replace(
            CIMConfig().macro, sim_level=level))
        for label, k, n, _ in DECODE_MVMS:
            w = torch.from_numpy((mrng.standard_normal((k, n)) * 0.02)
                                 .astype(np.float32)).to(dev)
            codes_, s_w = quantize_weight_offline(w, mcfg)
            wpk = ops.pack_codes(codes_)
            del w, codes_
            for m in (4, 64):
                x = torch.from_numpy(mrng.standard_normal((m, k)).astype(
                    np.float32)).to(dev)
                y0 = cim_matmul_prequant(x, wpk, s_w, mcfg)
                sharding.set_mesh(mesh)
                y1 = cim_matmul_prequant(x, wpk, s_w, mcfg)
                sharding.set_mesh(None)
                check(torch.equal(y0, y1), f"phase mesh: {level.name} "
                      f"{label} M={m} differs under the 1-rank mesh")
    log("phase mesh: B1 (IDEAL) and B6 (NOISY, seed 0, salt 0) through "
        "the sharded dispatch at the decode (M=4) and prefill (M=64) "
        "shapes of every layer MVM and the head: bit-identical to no mesh")
    # the sharded dispatch's host cost: one decode MVM (the first of
    # DECODE_MVMS, M = 4, IDEAL) called MESH_CALLS times a pass, without
    # and with the 1-rank mesh, MESH_PAIRS pairs of passes in alternating
    # order (none, mesh, mesh, none, ...) so the host's drift falls on
    # both; each pass ends with a synchronize, so µs a call is the host's
    # enqueue cost where it exceeds the card's
    label, k, n, _ = DECODE_MVMS[0]
    icfg = CIMConfig(enabled=True)
    w = torch.from_numpy((mrng.standard_normal((k, n)) * 0.02).astype(
        np.float32)).to(dev)
    codes_, s_w = quantize_weight_offline(w, icfg)
    wpk = ops.pack_codes(codes_)
    x = torch.from_numpy(mrng.standard_normal((4, k)).astype(np.float32)
                         ).to(dev)
    for _ in range(20):                                  # warm both paths
        cim_matmul_prequant(x, wpk, s_w, icfg)
    host_us = {"none": [], "mesh": []}
    for i in range(MESH_PAIRS):
        for tag in (("none", "mesh") if i % 2 == 0 else ("mesh", "none")):
            sharding.set_mesh(mesh if tag == "mesh" else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MESH_CALLS):
                cim_matmul_prequant(x, wpk, s_w, icfg)
            torch.cuda.synchronize()
            host_us[tag].append((time.perf_counter() - t0) / MESH_CALLS
                                * 1e6)
    sharding.set_mesh(None)
    diffs = [b_ - a_ for a_, b_ in zip(host_us["none"], host_us["mesh"])]
    extra = statistics.median(diffs)
    log(f"phase mesh ({card}): one {label} MVM (M=4, K={k}, N={n}, IDEAL, "
        f"B1), {MESH_PAIRS} pairs of passes of {MESH_CALLS} calls, us a "
        f"call: no mesh median {statistics.median(host_us['none']):.2f} "
        f"(passes {min(host_us['none']):.2f}-{max(host_us['none']):.2f}), "
        f"1-rank mesh median {statistics.median(host_us['mesh']):.2f} "
        f"({min(host_us['mesh']):.2f}-{max(host_us['mesh']):.2f}); mesh "
        f"less no mesh within a pair: median {extra:.2f} us "
        f"({min(diffs):.2f} to {max(diffs):.2f}), {extra * 169 / 1e3:.3f} "
        f"ms over a decode step's 169 MVMs")
    del w, codes_, wpk, x
    # a size-1 mesh axis runs no collective in the sharded MVM: nccl's are
    # exercised here, compressed_psum over "data" and a 1-stage pipeline
    xg = torch.from_numpy(mrng.standard_normal(4096).astype(np.float32)
                          ).to(dev)
    err0 = torch.from_numpy(mrng.standard_normal(4096).astype(np.float32)
                            * 1e-3).to(dev)
    y, err = compressed_psum(xg, mesh.get_group("data"), err0)
    xf = xg + err0
    scale = torch.clamp(xf.abs().max() / torch.full((), 127.0, device=dev),
                        min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    pipe = pipeline_apply(lambda p_, h: h * p_, torch.full((1,), 3.0,
                                                           device=dev),
                          xg.reshape(4, 1, 1024),
                          mesh=make_mesh((1,), ("stage",)))
    check(torch.equal(y, q * scale / 1.0)
          and torch.equal(pipe, xg.reshape(4, 1, 1024) * 3.0),
          "phase mesh: compressed_psum or the pipeline on nccl is wrong")
    log("phase mesh: compressed_psum over the 1-rank nccl group (MAX and "
        "int32 SUM all-reduces) and a 1-stage pipeline (broadcast): as "
        "their formulas")
    sharding.set_mesh(mesh)
    server = Server(ctx.params, ctx.cfg, ctx.serving, device=dev)
    counts_m, streams_m = ctx.serve_mix(server, ctx.prompts,
                                        "phase mesh: --mesh host",
                                        **short_mix)
    sharding.set_mesh(None)
    del server
    same = {k_: counts_m[k_] == counts_a[k_] for k_ in
            ("cim_mvm_grouped_packed", "paged_attn_call",
             "decode_write_attend_call")}
    log(f"phase mesh: --mesh host vs no mesh (phase tune's untuned serve): "
        f"streams identical: {streams_m == streams_a}; launches equal: "
        f"{same}")
    check(streams_m == streams_a and all(same.values()),
          "phase mesh: the 1-rank mesh serve differs from no mesh")
    log(f"phase mesh: {time.monotonic() - t_mesh:.1f} s in all")
    phase_fsdp(torch, np, dev, card, mesh)
    dist.destroy_process_group()


def phase_fsdp(torch, np, dev, card: str, mesh) -> None:
    """Phase "fsdp" (module docstring) on `mesh`, phase mesh's 1-rank
    nccl mesh."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import registry
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.parallel import sharding
    from repro_torch.runtime.trainer import Trainer, make_optimizer

    t_fsdp = time.monotonic()
    log("phase fsdp: the Trainer's placed state on phase mesh's mesh")
    cfg = ARCHS["internlm2-1.8b"].replace(n_layers=FSDP_LAYERS,
                                          cim=CIMConfig(enabled=True))
    shape = ShapeConfig("fsdp", FSDP_SEQ, FSDP_BATCH, "train")
    tc = TrainConfig(steps=100, lr=3e-4)
    runs = {}
    for tag, m in (("mesh", mesh), ("none", None)):
        sharding.set_mesh(m)
        try:
            tr = Trainer(cfg, shape, tc, str(ROOT / "build" / "fsdp_ckpt"),
                         device=dev)
            state = tr.init_state()
            losses, counts = [], []
            for i in range(FSDP_STEPS):
                build.reset_launch_counts()
                state, metrics = tr.step_fn(state, tr.batch(i))
                losses.append(float(metrics["loss"]))
                torch.cuda.synchronize()
                counts.append(build.launch_counts()["cim_mvm_grouped"])
        finally:
            sharding.set_mesh(None)
        runs[tag] = (tr.specs, losses, counts, state)
        del tr, state
    (specs, l_m, c_m, s_m), (_, l_n, c_n, s_n) = runs["mesh"], runs["none"]
    want = 2 * 7 * FSDP_LAYERS + 1
    same = tree_equal(torch, s_m, s_n)
    log(f"phase fsdp ({card}): {cfg.arch} x {FSDP_LAYERS} layers at full "
        f"width (d_model {cfg.d_model}, vocab {cfg.vocab}), --cim bp, "
        f"AdamW, batch {FSDP_BATCH} x seq {FSDP_SEQ}: the Trainer's "
        f"{FSDP_STEPS} steps with its state placed on the 1-rank nccl mesh "
        f"(no leaf cut: specs {'None' if specs is None else 'set'}) vs no "
        f"mesh: losses {l_m} / {l_n}, params and optimizer state "
        f"identical {same}; B2 launches a step {c_m} / {c_n}")
    check(specs is None, "phase fsdp: a 1-rank mesh cut a state leaf")
    check(l_m == l_n and same and all(math.isfinite(v) for v in l_m),
          "phase fsdp: the placed-state Trainer differs from no mesh")
    check(c_m == c_n and all(c == want for c in c_m),
          f"phase fsdp: B2 launched {c_m} / {c_n} times a step, expected "
          f"{want} (7 a layer, twice under remat, + head)")
    del runs, s_m, s_n
    torch.cuda.empty_cache()
    # rank 0's placed state of full-depth qwen2-moe with AdamW, planned
    qcfg = ARCHS["qwen2-moe-a2.7b"]
    params = registry.abstract_params(qcfg, max_seq=0)
    whole = {"params": params, "opt": make_optimizer(tc).init(params)}
    total = sum(t.numel() * t.element_size() for t in tree_leaves(whole))
    placed = []
    for plan in FSDP_PLANS:
        sharding.set_mesh(sharding.PlannedMesh(plan))
        try:
            specs = sharding.tree_param_specs(whole)
            blocks = sharding.tree_place(whole, specs)
            nbytes = sum(t.numel() * t.element_size()
                         for t in tree_leaves(blocks))
            check(nbytes == dr.per_chip_bytes(dr.Placed(whole, specs)),
                  f"phase fsdp: {plan}: rank 0's blocks are not the plan")
        finally:
            sharding.set_mesh(None)
        placed.append(f"{plan}: {nbytes / 2**30:.2f} GiB")
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    log(f"phase fsdp: {qcfg.arch} at full depth ({qcfg.n_layers} layers), "
        f"params + AdamW m / v: {total / 2**30:.2f} GiB whole; rank 0's "
        f"blocks as placed on the meta device: " + "; ".join(placed)
        + f"; the card holds {card_gib:.2f} GiB")
    log(f"phase fsdp: {time.monotonic() - t_fsdp:.1f} s in all")


# phase "ep": the per-rank launches of an ep-rank "model" axis
EP_RANKS = (2, 4, 8)
# B3 on a KV-head slice: (KH, G) of internlm2-1.8b and qwen2-moe-a2.7b
EP_HEADS = ((8, 2), (16, 1))


def phase_ep(torch, np, dev, card: str, ctx) -> dict:
    """Phase "ep" on phase 3m's full-width qwen2-moe-a2.7b (`ctx`: its
    server, serving config, prompts, the NOISY CIMConfig, the MVM keyword
    sets kw / noisy_kw, the seed tensors, the `codes` maker, main's
    serve_mix and phase 3m's no-mesh IDEAL and NOISY serves (counts,
    streams)): (a) B1e / B6e / B2e / B5e on each rank's expert slice for
    ep 2, 4, 8, against the whole launch and the plain version, timed;
    (b) B3 on each rank's KV-head slice (read in place), against the whole
    launch and the plain version, timed beside the whole launch; (c) the
    a2a exchange through nccl on the 1-rank group; (d) phase 3m's serves
    on the 1-rank nccl mesh, psum-EP at IDEAL and a2a-EP at NOISY: streams
    and launch counts equal to no mesh's. Returns the serves' B1e / B6e
    launches. A script under build/ can call it after phase 3m's
    serves."""
    import torch.distributed as dist

    from repro_torch.kernels import cim_mvm as cm
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.mesh import make_host_smoke_mesh
    from repro_torch.parallel import collectives, sharding
    from repro_torch.runtime.server import Server

    t_ep = time.monotonic()
    e_pad = MOE_EXPERTS
    # (a) the expert slices: rank r of ep takes experts [r·E/ep, (r+1)·E/ep)
    specs = (("B1e", cm.cim_mvm_grouped_packed_experts,
              cm.cim_mvm_grouped_packed_experts_plain, True, False),
             ("B6e", cm.cim_mvm_grouped_noisy_packed_experts,
              cm.cim_mvm_grouped_noisy_packed_experts_plain, True, True),
             ("B2e", stated_width(cm.cim_mvm_grouped_experts),
              cm.cim_mvm_grouped_experts_plain, False, False),
             ("B5e", stated_width(cm.cim_mvm_grouped_noisy_experts),
              cm.cim_mvm_grouped_noisy_experts_plain, False, True))
    slices = {}
    for kid, kern, plain, packed, noisy in specs:
        t_kid = time.monotonic()
        fkw = ctx.noisy_kw if noisy else ctx.kw
        extra = (ctx.seeds[7],) if noisy else ()
        per = {ep: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0,
                    "hash_ops": 0.0} for ep in EP_RANKS}
        for label, k, n, count in MOE_MVMS:
            x = ctx.codes((e_pad, MOE_CAPACITY, k))
            w = ctx.codes((e_pad, k, n))
            if packed:
                w = ops.pack_codes(w).contiguous()
            whole = kern(x, w, *extra, **fkw)
            for ep in EP_RANKS:
                el = e_pad // ep
                for r in range(ep):
                    xs, ws = x.narrow(0, r * el, el), w.narrow(0, r * el, el)
                    y = kern(xs, ws, *extra, **fkw)
                    check(torch.equal(y, whole[r * el:(r + 1) * el])
                          and torch.equal(y, plain(xs, ws, *extra, **fkw)),
                          f"phase ep: {kid} {label} rank {r} of {ep} "
                          "differs from the whole launch or its plain "
                          "version")
                xs, ws = x[:el].contiguous(), w[:el].contiguous()
                args = [(xs, wi) for wi in copies(ws)]
                t_k = graph_ms(torch, lambda a, b: kern(a, b, *extra, **fkw),
                               args)
                t_p = graph_ms(torch, lambda a, b: plain(a, b, *extra,
                                                         **fkw),
                               args[:2], reps=3, min_iters=2)
                rows = el * MOE_CAPACITY
                d = per[ep]
                d["ms"] += count * t_k
                d["plain_ms"] += count * t_p
                d["bytes"] += count * (ws.numel() * ws.element_size()
                                       + rows * k * 4 + rows * n * 4)
                d["ops"] += count * 2 * rows * k * n
                if noisy:
                    d["hash_ops"] += count * rows * n * (
                        -(-k // fkw["n_rows"]) * HASH_OPS_PER_CONVERSION
                        + HASH_OPS_PER_OUTPUT)
                del args, xs, ws
            del x, w, whole
            torch.cuda.empty_cache()
        for ep, d in per.items():
            b_bytes = d["bytes"] / HBM_BYTES_S * 1e3
            b_ops = max(d["ops"] / INT_OP_S, d["hash_ops"] / INT32_OP_S) * 1e3
            d["bound_ms"] = max(b_bytes, b_ops)
            d["bound_by"] = "bytes" if b_bytes >= b_ops else "operations"
        slices[kid] = per
        log(f"phase ep ({card}): {kid} on every rank's expert slice of ep "
            f"{EP_RANKS} (qwen2-moe-a2.7b, {e_pad} padded experts, C "
            f"{MOE_CAPACITY}, K 2048 <-> 1408): bit-exact vs the whole "
            f"launch and its plain version; one layer's 3 expert MVMs on "
            f"rank 0: " + "; ".join(
                f"ep {ep} ({e_pad // ep} experts): kernel {d['ms']:.4f} ms, "
                f"plain {d['plain_ms']:.3f} ms, bound {d['bound_ms']:.4f} "
                f"ms ({d['bound_by']})" for ep, d in per.items())
            + f"; {time.monotonic() - t_kid:.1f} s")

    # (b) B3 on a KV-head slice of the pools, read in place (strided)
    t_b3 = time.monotonic()
    rng = np.random.RandomState(41)
    b3_times = {}
    for kh, g in EP_HEADS:
        for bs in (16, 64):
            mb = 256 // bs
            nb = 4 * mb + 1
            pools = [torch.from_numpy(rng.standard_normal(
                (nb, bs, kh, 128)).astype(np.float32)).to(dev).bfloat16()
                for _ in range(2)]
            for p_ in pools:
                p_[0] = float("nan")
            tables = torch.from_numpy(rng.permutation(np.arange(1, nb))
                                      .astype(np.int32).reshape(4, mb)).to(dev)
            lens = torch.tensor([0, 37, 130, 224], dtype=torch.int32,
                                device=dev)
            for c in (1, 16):
                kvl = lens + torch.tensor([0, c, c, c], dtype=torch.int32,
                                          device=dev)
                q = torch.from_numpy(rng.standard_normal(
                    (4, c, kh * g, 128)).astype(np.float32)).to(dev)
                whole = pa.paged_attn_call(q, *pools, tables, lens, kvl)
                for ep in EP_RANKS:
                    khl = kh // ep
                    for r in range(ep):
                        hs = slice(r * khl * g, (r + 1) * khl * g)
                        qs = q[:, :, hs].contiguous()
                        ks, vs = (p_.narrow(2, r * khl, khl) for p_ in pools)
                        y = pa.paged_attn_call(qs, ks, vs, tables, lens, kvl)
                        check(torch.equal(y, whole[:, :, hs])
                              and torch.equal(y, pa.paged_attn_plain(
                                  qs, ks, vs, tables, lens, kvl)),
                              f"phase ep: B3 on KV heads {r * khl}.."
                              f"{(r + 1) * khl - 1} of {kh} (bs {bs}, C "
                              f"{c}) differs from the whole launch or its "
                              "plain version")
                if (kh, bs) == (8, 16):
                    pc = list(zip(copies(pools[0]), copies(pools[1])))
                    half = kh // 2
                    qs = q[:, :, :half * g].contiguous()
                    tag = "decode" if c == 1 else "prefill C=16"
                    t_w = graph_ms(torch, lambda a, v: pa.paged_attn_call(
                        q, a, v, tables, lens, kvl), pc)
                    t_s = graph_ms(torch, lambda a, v: pa.paged_attn_call(
                        qs, a.narrow(2, 0, half), v.narrow(2, 0, half),
                        tables, lens, kvl), pc)
                    t_sp = graph_ms(torch, lambda a, v: pa.paged_attn_plain(
                        qs, a.narrow(2, 0, half), v.narrow(2, 0, half),
                        tables, lens, kvl), pc[:2], reps=3, min_iters=2)
                    att = torch.minimum(
                        lens[:, None].long() + torch.arange(
                            c, device=dev)[None, :] + 1,
                        kvl[:, None].long()).sum().item()
                    bb = (int(kvl.sum()) * half * 128 * 2 * 2
                          + 2 * qs.numel() * 4) / HBM_BYTES_S * 1e3
                    bo = att * g * half * 128 * 4 / F32_FLOP_S * 1e3
                    b3_times[tag] = dict(ms=t_s, whole_ms=t_w, plain_ms=t_sp,
                                         bound_ms=max(bb, bo))
                    log(f"phase ep ({card}): B3 {tag}, dh 128, bs 16, KV "
                        f"heads 0-{half - 1} of {kh} read in place (rank 0 "
                        f"of 2): {t_s * 1e3:.2f} us on the card, the whole "
                        f"launch {t_w * 1e3:.2f} us, plain on the slice "
                        f"{t_sp * 1e3:.2f} us, bound {max(bb, bo) * 1e3:.2f}"
                        f" us ({'bytes' if bb >= bo else 'operations'})")
                    del pc
            del pools
    log(f"phase ep: B3 on every rank's KV-head slice (KH {EP_HEADS[0][0]} "
        f"and {EP_HEADS[1][0]}, ep {EP_RANKS}, bs 16 and 64, C 1 and 16, "
        f"dh 128, bf16 pools read in place): bit-exact vs the whole launch "
        f"and its plain version; {time.monotonic() - t_b3:.1f} s")

    # (c) the a2a exchange through nccl's all_to_all_single, 1-rank group
    mesh, m_data, m_model = make_host_smoke_mesh()
    group = mesh.get_group("model")
    send = torch.from_numpy(rng.standard_normal(
        (e_pad, MOE_CAPACITY, 2048)).astype(np.float32)).to(dev)
    recv = collectives.dispatch_exchange(send, group)
    back = collectives.combine_exchange(recv, group)
    check(torch.equal(recv, send) and torch.equal(back, send),
          "phase ep: a2a_dispatch then a2a_combine through nccl did not "
          "give the send buffer back")
    log(f"phase ep: a2a dispatch then combine through nccl's "
        f"all_to_all_single on the 1-rank group ({dist.get_backend()}): "
        f"send [{e_pad}, {MOE_CAPACITY}, 2048] back bit for bit")

    # (d) phase 3m's serves on the 1-rank mesh, psum-EP and a2a-EP
    mcfg = ctx.server.cfg
    out = {}
    for mode, cim, (counts0, streams0), kid, name in (
            ("psum", mcfg.cim, ctx.ideal, "B1e",
             "cim_mvm_grouped_packed_experts"),
            ("a2a", ctx.noisy, ctx.noisy_run, "B6e",
             "cim_mvm_grouped_noisy_packed_experts")):
        ecfg = mcfg.replace(cim=cim, moe=dataclasses.replace(
            mcfg.moe, ep_mode=mode))
        sharding.set_mesh(mesh)
        try:
            server = Server(ctx.server.params, ecfg, ctx.serving, device=dev)
            counts, streams = ctx.serve_mix(
                server, ctx.prompts, f"phase ep: {mode}-EP, "
                f"{'IDEAL' if cim is mcfg.cim else 'NOISY'}, host mesh "
                f"data={m_data} model={m_model}",
                new_tokens=SHORT_NEW_TOKENS)
        finally:
            sharding.set_mesh(None)
        del server
        same = {k_: counts[k_] == counts0[k_] for k_ in counts0}
        log(f"phase ep: {mode}-EP on the 1-rank mesh vs phase 3m's serve "
            f"without: streams identical: {streams == streams0}; launch "
            f"counts equal: {all(same.values())} ({kid} {counts[name]})")
        check(streams == streams0 and all(same.values()) and counts[name] > 0,
              f"phase ep: the {mode}-EP serve differs from no mesh")
        out[kid] = counts[name]
    dist.destroy_process_group()
    log(f"phase ep: {time.monotonic() - t_ep:.1f} s in all")
    return out


def phase_dryrun(torch, np, dev, card: str, server) -> dict:
    """Phase "dryrun" (module docstring) on `server`'s model: phase 3l's
    slot Server (internlm2-1.8b at full width, --cim bp-prequant, 4 slots,
    max_len 256). Returns the numbers it printed."""
    import torch.distributed as dist

    from repro_torch.analysis import hlo
    from repro_torch.analysis.roofline import Roofline, model_flops
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import registry, transformer
    from repro_torch.models.quantize import abstract_quantized_params
    from repro_torch.runtime.telemetry import KERNEL_COUNTERS

    t_phase = time.monotonic()
    out = {}
    # (a) the reference's CI cells
    had_group = dist.is_initialized()
    for arch, shape, mesh, cim, ep, want in DRYRUN_CELLS:
        t0 = time.monotonic()
        r = dr.run_cell(arch, shape, mesh, cim=cim, ep=ep)
        dt = time.monotonic() - t0
        log(f"phase dryrun (a): {dr.status_line(r)} ({dt:.2f} s)")
        if r["status"] == "ok":
            m, rl = r["memory_analysis"], r["roofline"]
            log(f"  program {r['program']} (work chips {rl['work_chips']}), "
                f"argument {m['argument_size_in_bytes']:.0f} B/chip, temp "
                f"{m['temp_size_in_bytes']:.0f} B, {rl['hlo_flops']:.0f} "
                f"FLOP, {rl['hlo_bytes']:.0f} B, collectives "
                f"{rl['collective_detail']}, t_compute "
                f"{rl['t_compute_s']:.6g} s, t_memory {rl['t_memory_s']:.6g}"
                f" s, t_collective {rl['t_collective_s']:.6g} s")
        check(r["status"] == want, f"phase dryrun: {r['cell']} is "
              f"{r['status']}, the reference's is {want}: "
              f"{r.get('error', r.get('reason'))}")
        if want == "skipped":
            check(r["reason"].startswith("skip: pure full-softmax"),
                  f"phase dryrun: {r['cell']} skipped for {r['reason']}")
        out[r["cell"]] = dt
    if dist.is_initialized() and not had_group:
        dist.destroy_process_group()       # --mesh host's 1-rank group
    t_a = time.monotonic() - t_phase

    # (b) the plan at phase 3l's own shape against one real step
    cfg, b, max_len = server.cfg, 4, 256
    params_m = abstract_quantized_params(registry.abstract_params(cfg), cfg)
    cache_m = transformer.init_cache(cfg, b, max_len, device="meta")
    tok_m = torch.empty((b, 1), dtype=torch.int32, device="meta")
    args = (dr.Placed(params_m, dr.params_shardings(params_m, None)),
            dr.Placed(tok_m, (None, None)),
            dr.Placed(cache_m, dr.cache_shardings(cache_m, None)))
    disp0 = sum(KERNEL_COUNTERS.backend_dispatch.values())
    t0 = time.monotonic()
    cost = dr.trace_step(
        lambda p, t, c: transformer.decode_step(p, t, c, cfg),
        tuple(a.tree for a in args), train=False)
    t_trace = time.monotonic() - t0
    dispatched = sum(KERNEL_COUNTERS.backend_dispatch.values()) - disp0
    planned_args = sum(dr.per_chip_bytes(a) for a in args)

    cache = transformer.init_cache(cfg, b, max_len, device=dev)
    cache["pos"].fill_(100)
    tok = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab, (b, 1)).astype(np.int32)).to(dev)

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for t in hlo.tensors(tree))

    real_args = nbytes(server.params) + nbytes(tok) + nbytes(cache)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    with torch.no_grad():
        transformer.decode_step(server.params, tok, cache, cfg)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    b1 = build.launch_counts()["cim_mvm_grouped_packed"]

    def step():
        with torch.no_grad():
            transformer.decode_step(server.params, tok, cache, cfg)

    t_graph = graph_ms(torch, step, [()], reps=3, min_iters=3)
    shape = ShapeConfig("decode_card", max_len, b, "decode")
    rl = Roofline(arch=cfg.arch, shape=shape.name, mesh="card1", chips=1,
                  hlo_flops=float(cost.flops), hlo_bytes=float(cost.bytes),
                  collective_bytes=0.0,
                  model_flops=model_flops(cfg, shape, params_m),
                  peak_bytes_per_chip=float(planned_args + cost.temp_bytes),
                  collective_detail={})
    bound_ms = 1e3 * max(rl.t_compute, rl.t_memory, rl.t_collective)
    log(f"phase dryrun (b) ({card}): {cfg.arch} slot decode step, {b} slots, "
        f"max_len {max_len}, --cim bp-prequant, one chip: meta trace "
        f"{t_trace:.2f} s; planned argument bytes {planned_args} vs the "
        f"real params + tokens + cache {real_args}; MVMs dispatched in the "
        f"trace {dispatched} (hook {cost.mvms}) vs B1 launches of one real "
        f"step {b1}; planned temp {cost.temp_bytes} B vs the real step's "
        f"max_memory_allocated growth {grown} B; {cost.flops} FLOP, "
        f"{cost.bytes} B -> t_compute {rl.t_compute * 1e3:.6f} ms, t_memory "
        f"{rl.t_memory * 1e3:.6f} ms, t_collective "
        f"{rl.t_collective * 1e3:.6f} ms (data-sheet peaks): bound "
        f"{bound_ms:.6f} ms vs the step's CUDA graph {t_graph:.4f} ms")
    check(planned_args == real_args, f"phase dryrun: planned argument bytes "
          f"{planned_args} != the real {real_args}")
    check(dispatched == cost.mvms == b1 == 169, f"phase dryrun: the trace "
          f"dispatched {dispatched} MVMs ({cost.mvms} counted), one real "
          f"step launched B1 {b1} times; expected 169")
    del cache
    t_all = time.monotonic() - t_phase
    log(f"phase dryrun ({card}): {t_all:.2f} s in all ((a) {t_a:.2f} s), "
        f"limit {DRYRUN_LIMIT_S:.0f} s")
    check(t_all <= DRYRUN_LIMIT_S, f"phase dryrun took {t_all:.1f} s, over "
          f"its {DRYRUN_LIMIT_S:.0f} s")
    out.update(planned_args=planned_args, real_args=real_args,
               mvms=dispatched, b1=b1, temp=cost.temp_bytes, grown=grown,
               bound_ms=bound_ms, graph_ms=t_graph, seconds=t_all)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs.registry import ARCHS, SMOKES
    from repro_torch.core.adc import stochastic_transfer_params
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.core.macro import MacroConfig, SimLevel
    from repro_torch.kernels import build, cim_mvm as cm, ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.core import engine
    from repro_torch.core.engine import PackedCodes
    from repro_torch.examples import kws_gru
    from repro_torch.models import (common, gru, mamba2, moe, registry,
                                    transformer)
    from repro_torch.models.quantize import quantize_params
    from repro_torch.runtime import obs
    from repro_torch.runtime.server import (Request, Server, ServerMetrics,
                                            ServingConfig)
    from repro_torch.runtime.server import _splice as splice
    from repro_torch.runtime.speculative import ModelDrafter, SamplingParams
    from repro_torch.runtime.telemetry import KERNEL_COUNTERS

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls stay f32
    dev = torch.device("cuda")

    # ---- phase 1: card, build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = smi.stdout.strip().splitlines()
    check(smi.returncode == 0 and bool(lines) and "," in lines[0],
          f"nvidia-smi gave no name and power limit (exit "
          f"{smi.returncode}): {smi.stderr.strip()[:200]}")
    card = lines[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    built = build.build_all()
    log(f"phase 1: kernels built in {time.monotonic() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in built.items()) or 'cached'})")

    report = {}
    kw = dict(n_rows=144, levels=362, gain=1.0, full_scale=32400.0)
    rng = np.random.default_rng(0)

    def codes(shape):
        return torch.from_numpy(rng.integers(0, 16, size=shape,
                                             dtype=np.uint8)).to(dev).float()

    # ---- phase 2: kernels against their plain versions --------------------
    err = {"B1": 0.0, "B2": 0.0}
    for m in (4, 64):
        for k, n in PARITY_KN:
            x, w = codes((m, k)), codes((k, n))
            wp = ops.pack_codes(w).contiguous()
            y1 = cm.cim_mvm_grouped_packed(x, wp, **kw)
            y1p = cm.cim_mvm_grouped_packed_plain(x, wp, **kw)
            y2 = cm.cim_mvm_grouped(x, w, **kw)
            y2p = cm.cim_mvm_grouped_plain(x, w, **kw)
            torch.cuda.synchronize()
            e1 = (y1 - y1p).abs().max().item()
            e2 = (y2 - y2p).abs().max().item()
            check(torch.equal(y1, y1p), f"B1 differs from its plain version "
                  f"at M={m} K={k} N={n}: max |err| {e1}")
            check(torch.equal(y2, y2p), f"B2 differs from its plain version "
                  f"at M={m} K={k} N={n}: max |err| {e2}")
            err["B1"], err["B2"] = max(err["B1"], e1), max(err["B2"], e2)
            del x, w, wp, y1, y1p, y2, y2p
    log("phase 2: B1, B2 bit-exact vs plain at M in {4, 64} x "
        f"{PARITY_KN} (tolerance 0)")

    # B5/B6: the seeded stochastic converter, NOISY (and FULL once)
    def stochastic_kw(level):
        st = stochastic_transfer_params(MacroConfig(sim_level=level))
        return dict(kw, sigma=st["sigma"], inl_amp=st["inl_amp"],
                    apply_inl=st["apply_inl"])

    noisy_kw, full_kw = (stochastic_kw(SimLevel.NOISY),
                         stochastic_kw(SimLevel.FULL))
    seeds = {v: torch.tensor([v], dtype=torch.int32, device=dev)
             for v in (0, 7)}
    err["B5"] = err["B6"] = 0.0
    for m in (4, 64):
        for k, n in PARITY_KN:
            x, w = codes((m, k)), codes((k, n))
            wp = ops.pack_codes(w).contiguous()
            for sd, seed in seeds.items():
                y5 = cm.cim_mvm_grouped_noisy(x, w, seed, **noisy_kw)
                y6 = cm.cim_mvm_grouped_noisy_packed(x, wp, seed, **noisy_kw)
                y5p = cm.cim_mvm_grouped_noisy_plain(x, w, seed, **noisy_kw)
                y6p = cm.cim_mvm_grouped_noisy_packed_plain(x, wp, seed,
                                                            **noisy_kw)
                torch.cuda.synchronize()
                e5 = (y5 - y5p).abs().max().item()
                e6 = (y6 - y6p).abs().max().item()
                where = f"at M={m} K={k} N={n} seed {sd}"
                check(bool(torch.isfinite(y5).all()), f"B5 not finite {where}")
                check(torch.equal(y5, y5p), f"B5 differs from its plain "
                      f"version {where}: max |err| {e5}")
                check(torch.equal(y6, y6p), f"B6 differs from its plain "
                      f"version {where}: max |err| {e6}")
                check(torch.equal(y6, y5), f"B6 differs from B5 {where}")
                err["B5"], err["B6"] = max(err["B5"], e5), max(err["B6"], e6)
                if sd == 0:
                    y0 = y5
            salted = cm.cim_mvm_grouped_noisy(x, w, seeds[0], inl_seed=3,
                                              **noisy_kw)
            check(not torch.equal(salted, y0), f"inl_seed 3 drew the same "
                  f"noise as inl_seed 0 at M={m} K={k} N={n}")
            del x, w, wp, y5, y6, y5p, y6p, y0, salted
    log("phase 2: B5, B6 bit-exact vs plain at NOISY, M in {4, 64} x "
        f"{PARITY_KN}, seeds 0 and 7 (tolerance 0); B6 == B5; inl_seed "
        "3 salts the draws")
    full_diff = 0
    for m in (4, 64):
        x, w = codes((m, 2048)), codes((2048, 2048))
        wp = ops.pack_codes(w).contiguous()
        y5 = cm.cim_mvm_grouped_noisy(x, w, seeds[7], inl_seed=3, **full_kw)
        y6 = cm.cim_mvm_grouped_noisy_packed(x, wp, seeds[7], inl_seed=3,
                                             **full_kw)
        y5p = cm.cim_mvm_grouped_noisy_plain(x, w, seeds[7], inl_seed=3,
                                             **full_kw)
        torch.cuda.synchronize()
        full_diff += int((y5 != y5p).sum()) + int((y6 != y5p).sum())
        err["B5"] = max(err["B5"], (y5 - y5p).abs().max().item())
        err["B6"] = max(err["B6"], (y6 - y5p).abs().max().item())
        del x, w, wp, y5, y6, y5p
    log(f"phase 2: B5, B6 at FULL (INL instance 3), M in {{4, 64}}, "
        f"K=N=2048: {full_diff} outputs differ from the plain version "
        f"(tolerance {FULL_TOL})")
    check(full_diff <= FULL_TOL, "B5/B6 at FULL differ from their plain "
          "versions beyond the tolerance")

    # every rung of the precision search's ADC ladder (a manifest serves
    # B1 at its sites' levels): lsb, inv_lsb, inv_lsb / L and code_max
    # change with L; internlm2-1.8b's widest layer shape
    for levels in LADDER:
        lkw = dict(kw, levels=levels)
        lnoisy, lfull = dict(noisy_kw, levels=levels), \
            dict(full_kw, levels=levels)
        for m in (4, 64):
            x, w = codes((m, 2048)), codes((2048, 8192))
            wp = ops.pack_codes(w).contiguous()
            where = f"at L={levels} M={m} K=2048 N=8192"
            for kid, y, yp in (
                    ("B1", cm.cim_mvm_grouped_packed(x, wp, **lkw),
                     cm.cim_mvm_grouped_packed_plain(x, wp, **lkw)),
                    ("B2", cm.cim_mvm_grouped(x, w, **lkw),
                     cm.cim_mvm_grouped_plain(x, w, **lkw))):
                check(torch.equal(y, yp), f"{kid} differs from its plain "
                      f"version {where}")
            for lv, lvkw in (("NOISY", lnoisy), ("FULL", lfull)):
                y5p = cm.cim_mvm_grouped_noisy_plain(x, w, seeds[7],
                                                     inl_seed=3, **lvkw)
                y5 = cm.cim_mvm_grouped_noisy(x, w, seeds[7], inl_seed=3,
                                              **lvkw)
                y6 = cm.cim_mvm_grouped_noisy_packed(x, wp, seeds[7],
                                                     inl_seed=3, **lvkw)
                check(torch.equal(y5, y5p), f"B5 at {lv} differs from its "
                      f"plain version {where}")
                check(torch.equal(y6, y5p), f"B6 at {lv} differs from B5's "
                      f"plain version {where}")
            torch.cuda.synchronize()
            del x, w, wp
    log(f"phase 2: B1, B2, B5 (NOISY and FULL, seed 7, INL instance 3) and "
        f"B6 bit-exact vs plain at every ADC ladder rung L in {LADDER}, M "
        "in {4, 64}, K=2048 N=8192 (tolerance 0)")

    # decode-step timing: M = 4 slots, every MVM shape of one step
    mvms = {"B1": (cm.cim_mvm_grouped_packed, cm.cim_mvm_grouped_packed_plain,
                   True, {}),
            "B2": (cm.cim_mvm_grouped, cm.cim_mvm_grouped_plain, False, {}),
            "B5": (cm.cim_mvm_grouped_noisy, cm.cim_mvm_grouped_noisy_plain,
                   False, noisy_kw),
            "B6": (cm.cim_mvm_grouped_noisy_packed,
                   cm.cim_mvm_grouped_noisy_packed_plain, True, noisy_kw)}
    for name, (kern, plain, packed, nkw) in mvms.items():
        tot = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bytes": 0.0,
               "ops": 0.0, "hash_ops": 0.0}
        extra = (seeds[0],) if nkw else ()
        fkw = nkw or kw

        def run_k(a, b):
            return kern(a, b, *extra, **fkw)

        def run_p(a, b):
            return plain(a, b, *extra, **fkw)

        for label, k, n, count in DECODE_MVMS:
            x = codes((4, k))
            w = codes((k, n))
            w = ops.pack_codes(w).contiguous() if packed else w
            ws = copies(w)
            args = [(x, wi) for wi in ws]
            t_k = graph_ms(torch, run_k, args)
            t_call = time_ms(torch, run_k, args)
            t_p = graph_ms(torch, run_p, args[:4], reps=3, min_iters=4)
            wbytes = w.numel() * w.element_size()
            log(f"  {name} {label:12s} M=4 K={k} N={n} x{count}/step: "
                f"kernel {t_k * 1e3:.2f} us on the card "
                f"({wbytes / (t_k * 1e-3) / 1e12:.3f} TB/s of "
                f"{wbytes / 1e6:.2f} MB weights), {t_call * 1e3:.2f} us "
                f"per eager call, plain {t_p * 1e3:.2f} us")
            tot["ms"] += count * t_k
            tot["call_ms"] += count * t_call
            tot["plain_ms"] += count * t_p
            tot["bytes"] += count * (wbytes + 4 * k * 4 + 4 * n * 4)
            tot["ops"] += count * 2 * 4 * k * n
            if nkw:
                groups = -(-k // kw["n_rows"])
                tot["hash_ops"] += count * (
                    4 * n * groups * HASH_OPS_PER_CONVERSION
                    + 4 * n * HASH_OPS_PER_OUTPUT)
            del x, w, ws
        b_bytes = tot["bytes"] / HBM_BYTES_S * 1e3
        b_ops = max(tot["ops"] / INT_OP_S, tot["hash_ops"] / INT32_OP_S) * 1e3
        report[name] = dict(
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=max(b_bytes, b_ops),
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            library_ms=None, max_abs_err=err[name])
        log(f"  {name} one decode step (169 MVMs): kernel {tot['ms']:.3f} ms "
            f"on the card, {tot['call_ms']:.3f} ms as eager calls, plain "
            f"{tot['plain_ms']:.3f} ms, bound {max(b_bytes, b_ops):.3f} ms "
            f"(weight bytes / 3.35 TB/s: {b_bytes:.3f} ms; operations: "
            f"{b_ops:.3f} ms, hash {tot['hash_ops'] / 1e9:.3f} G int32 ops)")
        # a prefill chunk: 4 slots x 16 tokens = 64 rows through the 168
        # layer MVMs (the head sees only each lane's last row, M = 4, timed
        # above)
        pre = {"ms": 0.0, "bytes": 0.0, "ops": 0.0, "hash_ops": 0.0}
        for label, k, n, count in DECODE_MVMS[:-1]:
            x = codes((64, k))
            w = codes((k, n))
            w = ops.pack_codes(w).contiguous() if packed else w
            ws = copies(w)
            t_k = graph_ms(torch, run_k, [(x, wi) for wi in ws])
            wbytes = w.numel() * w.element_size()
            log(f"  {name} {label:12s} M=64 K={k} N={n} x{count}/chunk: "
                f"kernel {t_k * 1e3:.2f} us on the card "
                f"({wbytes / (t_k * 1e-3) / 1e12:.3f} TB/s of weights)")
            pre["ms"] += count * t_k
            pre["bytes"] += count * (wbytes + 64 * k * 4 + 64 * n * 4)
            pre["ops"] += count * 2 * 64 * k * n
            if nkw:
                pre["hash_ops"] += count * 64 * n * (
                    -(-k // kw["n_rows"]) * HASH_OPS_PER_CONVERSION
                    + HASH_OPS_PER_OUTPUT)
            del x, w, ws
        pb_bytes = pre["bytes"] / HBM_BYTES_S * 1e3
        pb_ops = max(pre["ops"] / INT_OP_S,
                     pre["hash_ops"] / INT32_OP_S) * 1e3
        log(f"  {name} one prefill chunk's 168 layer MVMs at M=64: kernel "
            f"{pre['ms']:.3f} ms on the card, bound "
            f"{max(pb_bytes, pb_ops):.3f} ms (bytes {pb_bytes:.3f} ms, "
            f"operations {pb_ops:.3f} ms, hash "
            f"{pre['hash_ops'] / 1e9:.3f} G int32 ops)")
        if name != "B1":
            continue
        # a speculative verify step: 4 slots x (spec_k + 1) positions, the
        # head included (every position's logits)
        m_v = 4 * (SPEC_K + 1)
        ver = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0}
        for label, k, n, count in DECODE_MVMS:
            x = codes((m_v, k))
            ws = copies(ops.pack_codes(codes((k, n))).contiguous())
            args = [(x, wi) for wi in ws]
            t_k = graph_ms(torch, run_k, args)
            t_p = graph_ms(torch, run_p, args[:4], reps=3, min_iters=4)
            wbytes = ws[0].numel()
            log(f"  B1 {label:12s} M={m_v} K={k} N={n} x{count}/verify "
                f"step: kernel {t_k * 1e3:.2f} us on the card, plain "
                f"{t_p * 1e3:.2f} us")
            ver["ms"] += count * t_k
            ver["plain_ms"] += count * t_p
            ver["bytes"] += count * (wbytes + m_v * k * 4 + m_v * n * 4)
            ver["ops"] += count * 2 * m_v * k * n
            del x, ws
        vb = max(ver["bytes"] / HBM_BYTES_S, ver["ops"] / INT_OP_S) * 1e3
        log(f"  B1 one verify step (169 MVMs at M={m_v}): kernel "
            f"{ver['ms']:.3f} ms on the card, plain {ver['plain_ms']:.3f} "
            f"ms, bound {vb:.3f} ms")

    # B3: paged flash attention at the main path's shapes
    b, kh, g, dh, bs, mb = 4, 8, 2, 128, 16, 16
    nb = b * mb + 1
    k_pool = torch.from_numpy(rng.standard_normal((nb, bs, kh, dh),
                                                  dtype=np.float32)).to(dev)
    v_pool = torch.from_numpy(rng.standard_normal((nb, bs, kh, dh),
                                                  dtype=np.float32)).to(dev)
    k_pool, v_pool = k_pool.bfloat16(), v_pool.bfloat16()
    k_pool[0] = float("nan")        # trash block poison
    v_pool[0] = float("nan")
    lens = torch.tensor([0, 37, 130, 224], dtype=torch.int32, device=dev)
    tables = torch.zeros(b, mb, dtype=torch.int32, device=dev)
    perm = rng.permutation(np.arange(1, nb))
    for s in range(b):
        tables[s] = torch.from_numpy(perm[s * mb:(s + 1) * mb].astype(
            np.int32))
    b3_err = 0.0
    for c in (1, 16):
        valid = torch.tensor([0, c, c, c], dtype=torch.int32, device=dev)
        kvl = lens + valid
        q = torch.from_numpy(rng.standard_normal((b, c, kh * g, dh),
                                                 dtype=np.float32)).to(dev)
        o = pa.paged_attn_call(q, k_pool, v_pool, tables, lens, kvl)
        op = pa.paged_attn_plain(q, k_pool, v_pool, tables, lens, kvl)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(o).all()), f"B3 output not finite (C={c})")
        e = (o - op).abs().max().item()
        b3_err = max(b3_err, e)
        check(torch.equal(o, op), f"B3 differs from its plain version at "
              f"C={c}: max |err| {e} (tolerance 0)")
        check(bool((o[0] == 0).all()), "B3 idle lane must emit 0")
        if c == 1:
            q_dec, kvl_dec = q, kvl
        else:
            q_pre, kvl_pre = q, kvl
    log(f"phase 2: B3 bit-exact vs plain at C=1 and C=16, finite "
        f"(tolerance 0)")
    pool_copies = list(zip(copies(k_pool), copies(v_pool)))
    t_k = graph_ms(torch, lambda kp, vp: pa.paged_attn_call(
        q_dec, kp, vp, tables, lens, kvl_dec), pool_copies)
    t_call = time_ms(torch, lambda kp, vp: pa.paged_attn_call(
        q_dec, kp, vp, tables, lens, kvl_dec), pool_copies)
    t_p = graph_ms(torch, lambda kp, vp: pa.paged_attn_plain(
        q_dec, kp, vp, tables, lens, kvl_dec), pool_copies[:4], reps=3,
        min_iters=4)
    # library yardstick: SDPA over the pre-gathered bf16 window (the gather
    # is not timed), same masks
    win = mb * bs
    kw_ = common.paged_gather(k_pool, tables).permute(0, 2, 1, 3)
    vw_ = common.paged_gather(v_pool, tables).permute(0, 2, 1, 3)
    vw_ = torch.where((torch.arange(win, device=dev)[None, :]
                       < kvl_dec[:, None].long())[:, None, :, None], vw_, 0)
    qs = q_dec.permute(0, 2, 1, 3).bfloat16()
    mask = (torch.arange(win, device=dev)[None, :]
            < kvl_dec[:, None].long())[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_lib = graph_ms(torch, lambda: sdpa(qs, kw_, vw_, attn_mask=mask,
                                         enable_gqa=True), [()])
    kv_tokens = int(kvl_dec.sum())
    b3_bytes = kv_tokens * kh * dh * 2 * 2 + 2 * q_dec.numel() * 4
    b3_ops = kv_tokens * kh * g * dh * 4
    b_bytes, b_ops = b3_bytes / HBM_BYTES_S * 1e3, b3_ops / F32_FLOP_S * 1e3
    report["B3"] = dict(ms=t_k, plain_ms=t_p, bound_ms=max(b_bytes, b_ops),
                        bound_by="bytes" if b_bytes >= b_ops
                        else "operations", library_ms=t_lib,
                        max_abs_err=b3_err)
    log(f"  B3 decode C=1 B={b} KH={kh} G={g} dh={dh} bs={bs} "
        f"kv_len={kvl_dec.tolist()}: kernel {t_k * 1e3:.2f} us on the "
        f"card, {t_call * 1e3:.2f} us per eager call, plain "
        f"{t_p * 1e3:.2f} us, SDPA on the gathered window "
        f"{t_lib * 1e3:.2f} us")

    def b3_row(tag, q, kp, vp, tb, ln, kvl, pc=None):
        """Time B3 (CUDA-graph replays over pool copies `pc`) beside its
        plain version, SDPA on the pre-gathered window with the same causal
        and length masks (the gather is not timed) and its bound; log one
        row."""
        pc = pc or list(zip(copies(kp), copies(vp)))
        t_k = graph_ms(torch, lambda a, v: pa.paged_attn_call(
            q, a, v, tb, ln, kvl), pc)
        t_p = graph_ms(torch, lambda a, v: pa.paged_attn_plain(
            q, a, v, tb, ln, kvl), pc[:2], reps=3, min_iters=2)
        kh_, dh_ = kp.shape[2], kp.shape[3]
        pos_q = ln[:, None].long() + torch.arange(q.shape[1],
                                                  device=dev)[None, :]
        pos_s = torch.arange(tb.shape[1] * kp.shape[1], device=dev)
        kw = common.paged_gather(kp, tb).permute(0, 2, 1, 3)
        vw = torch.where((pos_s[None, :] < kvl[:, None].long())[
            :, None, :, None], common.paged_gather(vp, tb).permute(
                0, 2, 1, 3), 0)
        mask = ((pos_s[None, None, :] <= pos_q[:, :, None])
                & (pos_s[None, None, :] < kvl[:, None, None].long()))[:, None]
        qs = q.permute(0, 2, 1, 3).to(kp.dtype)
        t_lib = graph_ms(torch, lambda: sdpa(qs, kw, vw, attn_mask=mask,
                                             enable_gqa=True), [()])
        # bound: each slot's K/V rows read once, q read and out written
        # once; each query row attends its causal prefix
        att = torch.minimum(pos_q + 1, kvl[:, None].long()).sum().item()
        bb = (int(kvl.sum()) * kh_ * dh_ * kp.element_size() * 2
              + 2 * q.numel() * 4) / HBM_BYTES_S * 1e3
        bo = att * (q.shape[2] // kh_) * kh_ * dh_ * 4 / F32_FLOP_S * 1e3
        log(f"  B3 {tag} kv_len={kvl.tolist()}: kernel {t_k * 1e3:.2f} us "
            f"on the card, plain {t_p * 1e3:.2f} us, SDPA on the gathered "
            f"window {t_lib * 1e3:.2f} us, bound {max(bb, bo) * 1e3:.2f} us "
            f"({'bytes' if bb >= bo else 'operations'})")

    # B3 at a prefill chunk (C = 16: 32 query rows per KV head)
    b3_row("prefill C=16", q_pre, k_pool, v_pool, tables, lens, kvl_pre,
           pool_copies)

    # B4: the decode K/V write, inside B3's decode launch. Slot s writes
    # its new row at its position lens[s] (slot 0 idle: flat 0), as
    # paged_step builds the targets
    nk = torch.from_numpy(rng.standard_normal((b, 1, kh, dh),
                                              dtype=np.float32)).to(dev)
    nv = torch.from_numpy(rng.standard_normal((b, 1, kh, dh),
                                              dtype=np.float32)).to(dev)
    nk, nv = nk.bfloat16(), nv.bfloat16()
    col = (lens // bs).long()
    flat = (tables.gather(1, col[:, None])[:, 0] * bs + lens % bs).int()
    flat[0] = 0
    b4_err = 0.0
    for qx, out_dtype in ((q_dec, torch.float32),
                          (q_dec.bfloat16(), torch.bfloat16)):
        k2, v2, k3, v3 = (t.clone() for t in (k_pool, v_pool, k_pool,
                                              v_pool))
        o = pa.decode_write_attend_call(qx, k2, v2, nk, nv, flat, tables,
                                        lens, kvl_dec, out_dtype=out_dtype)
        op = pa.decode_write_attend_plain(qx, k3, v3, nk, nv, flat, tables,
                                          lens, kvl_dec).to(out_dtype)
        torch.cuda.synchronize()
        same = torch.equal(k2.view(torch.int16), k3.view(torch.int16)) and \
            torch.equal(v2.view(torch.int16), v3.view(torch.int16))
        check(same, "the decode launch's pools differ from B4's plain "
              "version")
        check(not torch.equal(k2.view(torch.int16), k_pool.view(torch.int16)),
              "the decode launch wrote no row")
        e = (o.float() - op.float()).abs().max().item()
        b4_err = max(b4_err, e)
        check(bool(torch.isfinite(o).all()) and torch.equal(o, op),
              f"the decode launch ({out_dtype}) differs from B4 then B3 "
              f"plain: max |err| {e} (tolerance 0)")
    log("phase 2: B3+B4 decode launch bit-exact vs B4 then B3 plain "
        "(outputs at f32 and bf16, both pools; tolerance 0)")
    del k3, v3

    # B4's time: the decode launch less B3 alone, same shapes, as the model
    # calls them (bf16 q and output), in turns (fused, B3, B3, fused)
    q16 = q_dec.bfloat16()

    def fused(kp, vp):
        return pa.decode_write_attend_call(q16, kp, vp, nk, nv, flat, tables,
                                           lens, kvl_dec,
                                           out_dtype=torch.bfloat16)

    def b3_alone(kp, vp):
        return pa.paged_attn_call(q16, kp, vp, tables, lens, kvl_dec,
                                  out_dtype=torch.bfloat16)

    t_f = [graph_ms(torch, fused, pool_copies)]
    t_b = [graph_ms(torch, b3_alone, pool_copies),
           graph_ms(torch, b3_alone, pool_copies)]
    t_f.append(graph_ms(torch, fused, pool_copies))
    t_fused, t_b3 = statistics.mean(t_f), statistics.mean(t_b)
    t_call = time_ms(torch, fused, pool_copies)
    k3, v3 = k_pool.clone(), v_pool.clone()
    t_p = graph_ms(torch, lambda: pa.fused_write_plain(k3, v3, nk, nv, flat),
                   [()], min_iters=20)
    rows = flat.long()
    kflat = k3.view(nb * bs, kh, dh)
    nk2 = nk.reshape(b, kh, dh)
    t_lib = graph_ms(torch, lambda: kflat.index_copy_(0, rows, nk2), [()],
                     min_iters=100)
    b4_bytes = 4 * b * kh * dh * 2       # K and V rows, read once, written once
    report["B4"] = dict(ms=t_fused - t_b3, plain_ms=t_p,
                        bound_ms=b4_bytes / HBM_BYTES_S * 1e3,
                        bound_by="bytes", library_ms=2 * t_lib,
                        max_abs_err=b4_err)
    log(f"  B4 B={b} rows of KH={kh} x dh={dh} bf16 inside the decode "
        f"launch: decode launch {' / '.join(f'{t * 1e3:.3f}' for t in t_f)} "
        f"us, B3 alone {' / '.join(f'{t * 1e3:.3f}' for t in t_b)} us "
        f"(bf16 q and output) -> B4 {(t_fused - t_b3) * 1e3:.3f} us; "
        f"{t_call * 1e3:.2f} us per eager call of the decode launch; plain "
        f"B4 {t_p * 1e3:.2f} us, 2x index_copy_ {2 * t_lib * 1e3:.2f} us")
    # B3 at a speculative verify step: C = spec_k + 1 query positions per
    # slot at decode depth (the new K/V already written)
    c_v = SPEC_K + 1
    kvl_v = lens + torch.tensor([0, c_v, c_v, c_v], dtype=torch.int32,
                                  device=dev)
    q_v = torch.from_numpy(rng.standard_normal((b, c_v, kh * g, dh),
                                               dtype=np.float32)).to(dev)
    o = pa.paged_attn_call(q_v, k_pool, v_pool, tables, lens, kvl_v)
    check(torch.equal(o, pa.paged_attn_plain(q_v, k_pool, v_pool, tables,
                                             lens, kvl_v)),
          "B3 differs from its plain version at the verify step C=5")
    b3_row(f"verify step C={c_v}", q_v, k_pool, v_pool, tables, lens, kvl_v,
           pool_copies)
    del k_pool, v_pool, k2, v2, k3, v3, pool_copies, kw_, vw_

    # B3 and the B3+B4 decode launch at every head dim and block size the
    # reference takes (C1 shapes), both pool dtypes, against the plain pair
    def c1_case(dh_, bs_, dtype):
        mb_ = max(2, 256 // bs_)
        nb_ = b * mb_ + 1
        kp_ = torch.from_numpy(rng.standard_normal(
            (nb_, bs_, kh, dh_), dtype=np.float32)).to(dev, dtype)
        vp_ = torch.from_numpy(rng.standard_normal(
            (nb_, bs_, kh, dh_), dtype=np.float32)).to(dev, dtype)
        kp_[0] = float("nan")
        vp_[0] = float("nan")
        tb_ = torch.from_numpy(rng.permutation(np.arange(1, nb_)).astype(
            np.int32)[:b * mb_].reshape(b, mb_)).to(dev)
        w_ = mb_ * bs_
        ln_ = torch.tensor([0, 37, w_ // 2 + 5, w_ - 17], dtype=torch.int32,
                           device=dev)
        return kp_, vp_, tb_, ln_

    for dh_, bs_ in C1_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            kp_, vp_, tb_, ln_ = c1_case(dh_, bs_, dtype)
            where = f"at dh={dh_} bs={bs_} {dtype}"
            for c in (1, SPEC_K + 1, 16):
                kvl_ = ln_ + torch.tensor([0, c, c, c], dtype=torch.int32,
                                          device=dev)
                q_ = torch.from_numpy(rng.standard_normal(
                    (b, c, kh * g, dh_), dtype=np.float32)).to(dev)
                o = pa.paged_attn_call(q_, kp_, vp_, tb_, ln_, kvl_)
                op = pa.paged_attn_plain(q_, kp_, vp_, tb_, ln_, kvl_)
                torch.cuda.synchronize()
                e = (o - op).abs().max().item()
                b3_err = max(b3_err, e)
                check(bool(torch.isfinite(o).all()) and torch.equal(o, op),
                      f"B3 differs from its plain version {where} C={c}: "
                      f"max |err| {e}")
            kvl_ = ln_ + torch.tensor([0, 1, 1, 1], dtype=torch.int32,
                                      device=dev)
            nk_ = torch.from_numpy(rng.standard_normal(
                (b, 1, kh, dh_), dtype=np.float32)).to(dev, dtype)
            nv_ = torch.from_numpy(rng.standard_normal(
                (b, 1, kh, dh_), dtype=np.float32)).to(dev, dtype)
            fl_ = (tb_.gather(1, (ln_ // bs_).long()[:, None])[:, 0] * bs_
                   + ln_ % bs_).int()
            fl_[0] = 0
            q_ = torch.from_numpy(rng.standard_normal(
                (b, 1, kh * g, dh_), dtype=np.float32)).to(dev)
            k2, v2, k3, v3 = (t.clone() for t in (kp_, vp_, kp_, vp_))
            o = pa.decode_write_attend_call(q_, k2, v2, nk_, nv_, fl_, tb_,
                                            ln_, kvl_)
            op = pa.decode_write_attend_plain(q_, k3, v3, nk_, nv_, fl_,
                                              tb_, ln_, kvl_)
            torch.cuda.synchronize()
            ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
            check(torch.equal(k2.view(ints), k3.view(ints))
                  and torch.equal(v2.view(ints), v3.view(ints))
                  and not torch.equal(k2.view(ints), kp_.view(ints)),
                  f"the decode launch's pools differ from B4's plain "
                  f"version {where}")
            e = (o - op).abs().max().item()
            b4_err = max(b4_err, e)
            check(torch.equal(o, op), f"the decode launch differs from B4 "
                  f"then B3 plain {where}: max |err| {e}")
            del kp_, vp_, k2, v2, k3, v3
    report["B3"]["max_abs_err"] = b3_err
    report["B4"]["max_abs_err"] = b4_err
    log(f"phase 2: B3 (C in 1, {SPEC_K + 1}, 16) and the B3+B4 decode "
        f"launch bit-exact vs plain at (dh, bs) in {list(C1_SHAPES)}, bf16 "
        "and f32 pools (tolerance 0)")
    # B3 alone at decode (f32 q, bf16 pools, as the dh 128 / bs 16 row
    # above) at dh 80 / bs 16 and dh 128 / bs 64
    for dh_, bs_ in ((80, 16), (128, 64)):
        kp_, vp_, tb_, ln_ = c1_case(dh_, bs_, torch.bfloat16)
        kvl_ = ln_ + torch.tensor([0, 1, 1, 1], dtype=torch.int32, device=dev)
        q_ = torch.from_numpy(rng.standard_normal(
            (b, 1, kh * g, dh_), dtype=np.float32)).to(dev)
        b3_row(f"decode C=1 dh={dh_} bs={bs_} MB={tb_.shape[1]}", q_, kp_,
               vp_, tb_, ln_, kvl_)
        del kp_, vp_

    # ---- shared by phases 3, 4 and 4b ------------------------------------
    def serve_mix(server, prompts, tag, sampling=None,
                  new_tokens=SERVE_NEW_TOKENS):
        """Phase 3's 8-request mix, `new_tokens` each (request i sampled
        with `sampling` and seed i, greedy without); launch counts are
        reset just before and read just after. Returns (the counts, the
        token streams)."""
        reqs = [Request(prompt=p, max_new_tokens=new_tokens)
                if sampling is None
                else Request(prompt=p, max_new_tokens=new_tokens,
                             sampling=SamplingParams(**sampling, seed=i))
                for i, p in enumerate(prompts)]
        # host wall time of each scheduler step (each ends by reading the
        # sampled tokens back), split by whether it prefilled
        step_s = {"prefill": [], "decode": []}
        inner = server.step

        def timed_step():
            t, before = time.monotonic(), server.metrics.prefill_tokens
            inner()
            kind = ("prefill" if server.metrics.prefill_tokens > before
                    else "decode")
            step_s[kind].append(time.monotonic() - t)

        server.step = timed_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.monotonic()
        for r in reqs:
            server.submit(r)
        server.run_until_drained()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        counts = build.launch_counts()
        del server.step
        log(f"{tag}: host time per step: " + ", ".join(
            f"{len(v)} {k} steps, median {1e3 * statistics.median(v):.1f} "
            f"ms, total {sum(v):.2f} s" for k, v in step_s.items() if v))
        peak = torch.cuda.max_memory_allocated() / 2**30
        for r in reqs:
            log(f"{tag} req{r.rid}: prompt_len={len(r.prompt)} -> {r.output}")
            check(len(r.output) == new_tokens
                  and all(0 <= t < server.cfg.vocab for t in r.output),
                  f"{tag} req{r.rid}: bad output {r.output}")
        total = sum(len(r.output) for r in reqs)
        m = server.metrics.summary()
        log(f"{tag}: 8 requests, {total} tokens, {server.steps_run} steps, "
            f"{dt:.2f} s ({total / dt:.1f} tok/s), peak memory {peak:.2f} "
            f"GiB, prefix_hit_tokens={m['prefix_hit_tokens']} "
            f"cow_forks={m['cow_forks']} preemptions={m['preemptions']}")
        log(f"{tag}: launches {counts}")
        if server.drafter is not None:
            log(f"{tag}: speculative drafter={server.serving.drafter} "
                f"spec_k={server.spec_k} spec_steps={m['spec_steps']} "
                f"draft_tokens={m['draft_tokens']} accept_rate="
                f"{m['accept_rate']:.4f} mean_accept_len="
                f"{m['mean_accept_len']:.4f} accept_hist={m['accept_hist']}")
        check(m["prefix_hit_tokens"] >= 32, "the shared prefix was not reused")
        return counts, [r.output for r in reqs]

    def two_steps(params, step_cfg):
        """One prefill (C=16) and one decode step from an empty pool;
        (the two logits, the pools)."""
        cache = transformer.init_paged_cache(step_cfg, 4 * 16 + 1, 16,
                                             device=dev)
        tb = torch.arange(1, 65, dtype=torch.int32, device=dev).reshape(4, 16)
        srng = np.random.RandomState(7)
        vocab = step_cfg.vocab
        toks = torch.from_numpy(srng.randint(0, vocab, (4, 16))).to(dev)
        valid = torch.tensor([16, 16, 9, 0], device=dev)
        l1, cache = transformer.paged_step(
            params, toks, cache, tb, torch.zeros(4, device=dev,
                                                        dtype=torch.long),
            valid, step_cfg)
        nxt = torch.from_numpy(srng.randint(0, vocab, (4, 1))).to(dev)
        l2, cache = transformer.paged_step(
            params, nxt, cache, tb, valid,
            torch.tensor([1, 1, 1, 0], device=dev), step_cfg)
        return (l1, l2), cache["layers"]

    def check_steps(server, tag, layers=None):
        """The two steps with the kernels and with their plain versions
        must give identical logits and pools (blocks >= 1: the trash
        block takes masked writes by design); over the first `layers`
        layers of the stack where given."""
        params, cfg = server.params, server.cfg
        if layers is not None:
            params = {**params, "layers": params["layers"][:layers]}
            cfg = cfg.replace(n_layers=layers)
            tag = f"{tag}, {layers} of {server.cfg.n_layers} layers"
        l_k, pools_k = two_steps(params, cfg)
        plain_cfg = cfg.replace(
            attn_backend="plain",
            cim=dataclasses.replace(cfg.cim, backend="plain"))
        l_p, pools_p = two_steps(params, plain_cfg)
        torch.cuda.synchronize()
        step_err = 0.0
        for a, p_ in zip(l_k, l_p):
            check(a.shape == (4, server.cfg.vocab)
                  and bool(torch.isfinite(a).all()),
                  "paged_step logits malformed")
            step_err = max(step_err, (a[:3] - p_[:3]).abs().max().item())
        same_pools = all(torch.equal(pools_k[n][:, 1:], pools_p[n][:, 1:])
                         for n in ("k", "v"))
        log(f"{tag}: paged_step prefill C=16 + decode C=1, kernels vs plain "
            f"versions: max |dlogit| = {step_err} (tolerance 0, bit-exact), "
            f"pools identical: {same_pools}")
        check(step_err == 0.0 and same_pools, f"{tag}: kernel and plain "
              "paged_step logits or pools differ")

    def decode_breakdown(server, tag, decode_step=None, slots=4):
        """Where a decode step's time goes: the whole C=1 step captured
        into a CUDA graph gives the card's time; the eager step adds the
        host's; torch.profiler gives device time by kernel name. The step
        is a paged one over `server` unless `decode_step` is given (then
        `server` is unused)."""
        note = ""
        if decode_step is None:
            dtok = torch.from_numpy(np.random.RandomState(8).randint(
                0, server.cfg.vocab, (4, 1))).to(dev)
            if server.cfg.arch == "internlm2-1.8b":
                note = (" (7,987 with B4 launched alone and the casts "
                        "around B3)")
            dcache = transformer.init_paged_cache(server.cfg, 4 * 16 + 1, 16,
                                                  device=dev)
            dtb = torch.arange(1, 65, dtype=torch.int32,
                               device=dev).reshape(4, 16)
            dlens = torch.tensor([40, 100, 17, 0], device=dev)
            dvalid = torch.tensor([1, 1, 1, 0], device=dev)

            def decode_step():
                transformer.paged_step(server.params, dtok, dcache, dtb,
                                       dlens, dvalid, server.cfg)

        t_dev = graph_ms(torch, decode_step, [()], reps=3, min_iters=3)
        t_eager = time_ms(torch, decode_step, [()], reps=3, min_iters=3)
        log(f"{tag}: one decode step ({slots} slots, C=1): {t_dev:.2f} ms on "
            f"the card (CUDA graph), {t_eager:.2f} ms eager -> the card is idle "
            f"{100 * (1 - t_dev / t_eager):.1f} % of the eager step")
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            decode_step()
            torch.cuda.synchronize()

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))

        # kernels only: an aten op's row repeats the time of its kernels
        rows_ = sorted((e for e in prof.key_averages()
                        if str(getattr(e, "device_type", "")).endswith(
                            "CUDA")), key=dev_us, reverse=True)
        total_us = sum(dev_us(e) for e in rows_)
        if total_us <= 0:
            log(f"{tag}: profiler recorded no device time (not measured)")
        else:
            log(f"{tag}: profiled decode step: {total_us / 1e3:.3f} ms of "
                f"kernel time in {sum(e.count for e in rows_)} launches"
                + note)
        for e in rows_[:12] if total_us > 0 else []:
            log(f"  profile: {dev_us(e) / 1e3:8.3f} ms "
                f"{100 * dev_us(e) / total_us:5.1f} %  x{e.count:<5d} "
                f"{e.key[:100]}")

    def short_serve(server, prompts, tag):
        """2 requests x 4 tokens; returns the launch counts of the run."""
        reqs = [Request(prompt=prompts[i][:24], max_new_tokens=4)
                for i in (1, 2)]
        build.reset_launch_counts()
        t0 = time.monotonic()
        for r in reqs:
            server.submit(r)
        server.run_until_drained()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        counts = build.launch_counts()
        for r in reqs:
            log(f"{tag} req{r.rid}: -> {r.output}")
            check(len(r.output) == 4, f"{tag} req{r.rid}: bad output "
                  f"{r.output}")
        log(f"{tag}: 2 requests x 4 tokens in {dt:.2f} s; launches {counts}")
        return counts

    # B2's kernel body at phase 3f's shapes, while the profiler records it
    f_bodies = b2_bodies(torch, np, dev)
    build.reset_launch_counts()
    log(f"phase 2: B2's kernel body at phase 3f's shapes (x [M, K] x [K, N], "
        f"L 362; {card}): " + ", ".join(
            f"[{m}, {k}] x [{k}, {n}] {_fmt_us(us)}"
            for (m, k, n), us in f_bodies.items()) + " (profiler)")

    # ---- phase 3: full-width paged serve, --cim bp-prequant --------------
    cfg = ARCHS["internlm2-1.8b"].replace(cim=CIMConfig(enabled=True))
    t0 = time.monotonic()
    params = registry.init_params(cfg, seed=0, device=dev)
    serving = ServingConfig(paged=True, prequant=True, packed=True,
                            attn="kernel", n_slots=4, max_len=256,
                            prefill_chunk=16)
    server = Server(params, cfg, serving, device=dev)
    torch.cuda.synchronize()
    log(f"phase 3: {cfg.arch} full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}) initialised and packed in "
        f"{time.monotonic() - t0:.1f} s")
    prng = np.random.RandomState(1234)
    prefix = prng.randint(0, cfg.vocab, size=32).tolist()
    lengths = prng.randint(16, 97, size=8)
    lengths[0], lengths[6] = max(lengths[0], 48), max(lengths[6], 40)
    prompts = [prng.randint(0, cfg.vocab, size=int(n)).tolist()
               for n in lengths]
    for i in (0, 6):
        prompts[i] = prefix + prompts[i][32:]
    counts, _ = serve_mix(server, prompts, "phase 3")
    # B3 runs alone at prefill and with B4 folded in at decode
    check(counts["paged_attn_call"] > 0, "B3 was not launched at prefill")
    for name, n in (("B1", counts["cim_mvm_grouped_packed"]),
                    ("B3+B4", counts["decode_write_attend_call"])):
        check(n > 0, f"{name} was not launched on the main path")
    check_steps(server, "phase 3")
    decode_breakdown(server, "phase 3")

    # ---- phase 3s: speculative decoding at phase 3's width ---------------
    # (a) one verify step (C = spec_k + 1, every position's logits) after a
    # prefill chunk, with the kernels and with their plain versions
    def verify_step(step_cfg):
        cache = transformer.init_paged_cache(step_cfg, 4 * 16 + 1, 16,
                                             device=dev)
        tb = torch.arange(1, 65, dtype=torch.int32, device=dev).reshape(4, 16)
        srng = np.random.RandomState(9)
        toks = torch.from_numpy(srng.randint(0, cfg.vocab, (4, 16))).to(dev)
        valid = torch.tensor([16, 16, 9, 0], device=dev)
        _, cache = transformer.paged_step(
            server.params, toks, cache, tb,
            torch.zeros(4, device=dev, dtype=torch.long), valid, step_cfg)
        draft = torch.from_numpy(srng.randint(0, cfg.vocab,
                                              (4, SPEC_K + 1))).to(dev)
        logits, cache = transformer.paged_step(
            server.params, draft, cache, tb, valid,
            torch.tensor([SPEC_K + 1, 3, 1, 0], device=dev), step_cfg,
            all_logits=True)
        return logits, cache["layers"]

    build.reset_launch_counts()
    l_k, pools_k = verify_step(server.cfg)
    torch.cuda.synchronize()
    v_counts = build.launch_counts()
    l_p, pools_p = verify_step(server.cfg.replace(
        attn_backend="plain",
        cim=dataclasses.replace(server.cfg.cim, backend="plain")))
    torch.cuda.synchronize()
    check(l_k.shape == (4, SPEC_K + 1, cfg.vocab)
          and bool(torch.isfinite(l_k[:3]).all()),
          "phase 3s: verify-step logits malformed")
    v_err = (l_k[:3] - l_p[:3]).abs().max().item()
    same_pools = all(torch.equal(pools_k[n][:, 1:].view(torch.int16),
                                 pools_p[n][:, 1:].view(torch.int16))
                     for n in ("k", "v"))
    log(f"phase 3s: verify step C={SPEC_K + 1} (all logits), kernels vs "
        f"plain versions: max |dlogit| = {v_err}, pools identical: "
        f"{same_pools} (tolerance 0); launches {v_counts}")
    check(v_err == 0.0 and same_pools, "phase 3s: kernel and plain verify "
          "steps differ")
    check(v_counts["cim_mvm_grouped_packed"] > 0
          and v_counts["paged_attn_call"] > 0,
          "phase 3s: the verify step did not launch B1 and B3")
    del server, l_k, l_p, pools_k, pools_p
    # (b) the greedy spec serve, (c) the sampled spec serve, twice
    spec_serving = dataclasses.replace(serving, drafter="ngram",
                                       spec_k=SPEC_K)
    counts, _ = serve_mix(Server(params, cfg, spec_serving, device=dev),
                          prompts, "phase 3s: greedy ngram",
                          new_tokens=SHORT_NEW_TOKENS)
    check(counts["cim_mvm_grouped_packed"] > 0
          and counts["paged_attn_call"] > 0,
          "phase 3s: the spec serve did not launch B1 and B3")
    sampled = dict(temperature=0.7, top_k=8)
    streams = [serve_mix(Server(params, cfg, spec_serving, device=dev),
                         prompts, f"phase 3s: sampled ngram run {i}",
                         sampling=sampled, new_tokens=SHORT_NEW_TOKENS)[1]
               for i in (1, 2)]
    check(streams[0] == streams[1], "phase 3s: two sampled spec serves gave "
          "different streams")
    log("phase 3s: the two sampled spec serves (temperature 0.7, top-k 8, "
        "seeds 0-7) gave identical streams")

    # ---- phase 3t: telemetry, parallel samples, trie watermark -----------
    tel_serving = dataclasses.replace(serving, telemetry=True,
                                      trie_watermark=0.25)

    def drain_3t(server, hook_s):
        """One drain of phase 3t's mix on a reused server (prefix cache
        flushed, metrics and telemetry reset): the forked requests 0 and 1
        first, stepping until both clones are installed, then the rest.
        Returns (requests, launch counts, KERNEL_COUNTERS snapshot, drain
        seconds, step() wall seconds, hook seconds, seconds the host
        spent enqueueing the model steps)."""
        server.flush_prefix_cache()
        server.metrics = ServerMetrics()
        server.telemetry.reset()
        reqs = [Request(prompt=p, max_new_tokens=16,
                        n_samples=2 if i < 2 else 1)
                for i, p in enumerate(prompts)]
        wall, enqueue = [0.0], [0.0]
        inner, model_step = server.step, transformer.paged_step

        def timed_step():
            t = time.perf_counter()
            inner()
            wall[0] += time.perf_counter() - t

        def timed_model_step(*a, **kw):
            t = time.perf_counter()
            out = model_step(*a, **kw)
            enqueue[0] += time.perf_counter() - t
            return out

        server.step = timed_step
        transformer.paged_step = timed_model_step
        torch.cuda.synchronize()
        build.reset_launch_counts()
        KERNEL_COUNTERS.reset()
        hook_s[0] = 0.0
        t0 = time.monotonic()
        for r in reqs[:2]:
            server.submit(r)
        kids = [c for r in reqs[:2] for c in r.samples]
        for _ in range(64):
            if all(any(x is c for x in server.slot_req) for c in kids):
                break
            server.step()
        check(all(any(x is c for x in server.slot_req) for c in kids),
              "phase 3t: the clones were not installed")
        for r in reqs[2:]:
            server.submit(r)
        server.run_until_drained()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        del server.step
        transformer.paged_step = model_step
        return (reqs, build.launch_counts(), KERNEL_COUNTERS.snapshot(), dt,
                wall[0], hook_s[0], enqueue[0])

    def instrument(tel):
        """Shadow each recording hook on the instance with a self-timing
        wrapper; returns the accumulator."""
        acc = [0.0]
        for name in TEL_HOOKS:
            def timed(*a, _base=getattr(tel, name), **kw):
                t = time.perf_counter()
                r = _base(*a, **kw)
                acc[0] += time.perf_counter() - t
                return r
            setattr(tel, name, timed)
        return acc

    # one server drains with its telemetry switched on and off in turns
    # (on and off timed on the same instance); a second one, built with
    # ServingConfig(telemetry=False), drains once more
    srv_on = Server(params, cfg, tel_serving, device=dev)
    srv_off = Server(params, cfg, dataclasses.replace(tel_serving,
                                                      telemetry=False),
                     device=dev)
    check((srv_on._trie_hi, srv_on._trie_lo) == (16, 8),
          f"phase 3t: trie watermarks {srv_on._trie_hi}/{srv_on._trie_lo} "
          "blocks, expected 16/8 of 64")
    hooks_on, hooks_off = instrument(srv_on.telemetry), [0.0]
    ratios, streams_3t = [], []
    tok_s = {"on": [], "off": [], "config off": []}
    for i, leg in enumerate(("on", "off", "on", "off", "on", "config off")):
        srv = srv_off if leg == "config off" else srv_on
        srv.telemetry.enabled = leg == "on"
        reqs, counts, kc, dt, wall, hook, enq = drain_3t(
            srv, hooks_on if leg == "on" else hooks_off)
        m = srv.metrics.to_dict()
        done = [x for r in reqs for x in (r, *r.samples)]
        total = sum(len(x.output) for x in done)
        tok_s[leg].append(total / dt)
        streams_3t.append([x.output for x in done])
        tag = f"phase 3t ({card}): telemetry {leg} drain {i + 1}"
        for x in done:
            check(len(x.output) == 16 and all(0 <= t < cfg.vocab
                                              for t in x.output),
                  f"{tag} req{x.rid}: bad output {x.output}")
        for r in reqs[:2]:
            check(r.samples[0].output == r.output,
                  f"{tag}: clone req{r.samples[0].rid} {r.samples[0].output}"
                  f" differs from its parent req{r.rid} {r.output}")
        check(m["cow_forks"] > 0 and m["trie_sweep_freed"] > 0,
              f"{tag}: cow_forks {m['cow_forks']}, trie_sweep_freed "
              f"{m['trie_sweep_freed']}")
        b1 = counts["cim_mvm_grouped_packed"]
        b3 = counts["paged_attn_call"] + counts["decode_write_attend_call"]
        check(kc["backend_dispatch"] == {"cuda_packed": b1} and b1 > 0,
              f"{tag}: backend_dispatch {kc['backend_dispatch']} against "
              f"{b1} B1 launches")
        check(kc["attn_dispatch"] == {"kernel": b3}
              and counts["paged_attn_call"] > 0
              and counts["decode_write_attend_call"] > 0,
              f"{tag}: attn_dispatch {kc['attn_dispatch']} against B3 "
              f"{counts['paged_attn_call']} + decode launch "
              f"{counts['decode_write_attend_call']}")
        log(f"{tag}: {total} tokens in {m['steps']} steps, {dt:.2f} s "
            f"({total / dt:.1f} tok/s); step() wall {wall:.3f} s, of it "
            f"{enq:.3f} s enqueueing paged_step; "
            f"cow_forks={m['cow_forks']} trie_sweep_freed="
            f"{m['trie_sweep_freed']} prefix_hit_tokens="
            f"{m['prefix_hit_tokens']}; launches {counts}; "
            f"KERNEL_COUNTERS backend {kc['backend_dispatch']} attn "
            f"{kc['attn_dispatch']}")
        if leg != "on":
            check(not srv.telemetry.events, f"{tag}: recorded events")
            continue
        ratios.append(hook / wall)
        log(f"{tag}: recording hooks {hook * 1e3:.3f} ms = "
            f"{100 * hook / wall:.4f} % of step() wall")
        if len(ratios) == 1:
            main_launches = {"B1": b1, "B3": b3,
                             "B4": counts["decode_write_attend_call"]}
            log(f"phase 3t ({card}): launches of the first drain, the "
                f"kernels line's B1/B3/B4: {main_launches}")
    check(all(st == streams_3t[0] for st in streams_3t),
          "phase 3t: the drains gave different streams (telemetry on vs "
          "off, or drain to drain)")
    tel = srv_on.telemetry
    doc = obs.chrome_trace(tel)
    problems = obs.validate_chrome_trace(doc)
    check(problems == [], f"phase 3t: Chrome trace invalid: {problems[:5]}")
    prom = obs.prometheus_text(tel, srv_on)
    overhead = statistics.median(ratios)
    log(f"phase 3t ({card}): ttft p50 {tel.ttft.percentile(50) * 1e3:.3f} "
        f"ms p99 {tel.ttft.percentile(99) * 1e3:.3f} ms | itl p50 "
        f"{tel.itl.percentile(50) * 1e3:.3f} ms p99 "
        f"{tel.itl.percentile(99) * 1e3:.3f} ms | step_wall p50 "
        f"{tel.step_wall.percentile(50) * 1e3:.3f} ms (last on drain)")
    log(f"phase 3t ({card}): events by kind {dict(sorted(tel.counters.items()))}"
        f"; Chrome trace {len(doc['traceEvents'])} events, valid; "
        f"Prometheus {len(prom.splitlines())} lines")
    log(f"phase 3t ({card}): tok/s " + "; ".join(
        f"telemetry {k} {', '.join(f'{v:.2f}' for v in vs)}"
        for k, vs in tok_s.items()) + f"; hook overhead per on drain "
        f"{[f'{100 * r:.4f} %' for r in ratios]}, median "
        f"{100 * overhead:.4f} % (limit {100 * HOOK_LIMIT:.0f} %)")
    check(overhead < HOOK_LIMIT, f"phase 3t: telemetry hooks take "
          f"{100 * overhead:.3f} % of step() wall (limit 3 %)")
    # the host cost of KERNEL_COUNTERS per decode step: the engine hook
    # alone, on the 169 packed weights (`<name>_q`, K = 2 x byte rows) of
    # one decode step (4 slots, C = 1)
    packed_ws = []

    def walk(t):
        if isinstance(t, dict):
            for k, v in t.items():
                if k.endswith("_q"):
                    packed_ws.append(PackedCodes(v, 2 * v.shape[0]))
                else:
                    walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(srv_on.params)
    check(len(packed_ws) == 169, f"phase 3t: {len(packed_ws)} packed "
          "weights, expected 169")
    xs = {k: torch.zeros(4, 1, k, device=dev)
          for k in {w.k for w in packed_ws}}
    macro = cfg.cim.macro
    KERNEL_COUNTERS.reset()
    per_step = []
    for _ in range(7):
        t = time.perf_counter()
        for w in packed_ws:
            engine._record_dispatch("cuda_packed", xs[w.k], w, macro)
        per_step.append(time.perf_counter() - t)
    KERNEL_COUNTERS.reset()
    kc_us = statistics.median(per_step[2:]) * 1e6
    kc_share = kc_us / (tel.step_wall.percentile(50) * 1e6)
    log(f"phase 3t ({card}): KERNEL_COUNTERS host cost {kc_us:.1f} us per "
        f"decode step (169 count_backend + add_site_energy calls, median "
        f"of 5 steps), {100 * kc_share:.4f} % of the median step wall")
    del srv_on, srv_off, srv, packed_ws, xs

    # ---- phase 3l: the slot engine (paged=False) at phase 3's width ------
    slot_serving = ServingConfig(prequant=True, packed=True, n_slots=4,
                                 max_len=256)

    def slot_serve(server, prompts_, tag, kname, per_fwd,
                   new_tokens=SERVE_NEW_TOKENS):
        """Phase 3's 8 requests (`prompts_`), `new_tokens` each, greedy,
        through a slot-engine Server; launch counts are reset just before
        and read just after: `kname` must launch `per_fwd` times per decode
        step and per prefill, the paged attention kernel never. Returns
        (the counts, the streams)."""
        check(not server.paged, f"{tag}: not the slot engine")
        reqs = [Request(prompt=p, max_new_tokens=new_tokens)
                for p in prompts_]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t0 = time.monotonic()
        for r in reqs:
            server.submit(r)
        server.run_until_drained()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        counts = build.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        for r in reqs:
            log(f"{tag} req{r.rid}: prompt_len={len(r.prompt)} -> {r.output}")
            check(len(r.output) == new_tokens
                  and all(0 <= t < server.cfg.vocab for t in r.output),
                  f"{tag} req{r.rid}: bad output {r.output}")
        m = server.metrics.summary()
        total = sum(len(r.output) for r in reqs)
        log(f"{tag}: 8 requests, {total} tokens, {server.steps_run} decode "
            f"steps and 8 prefills, {dt:.2f} s ({total / dt:.1f} tok/s), "
            f"peak memory {peak:.2f} GiB, prefill_tokens="
            f"{m['prefill_tokens']} decode_tokens={m['decode_tokens']} "
            f"wall_s={m['wall_s']:.3f}; launches {counts}")
        check(counts[kname] == per_fwd * (server.steps_run + len(reqs)),
              f"{tag}: {counts[kname]} {kname} launches, expected {per_fwd} "
              f"per decode step and per prefill ({server.steps_run} + "
              f"{len(reqs)})")
        check(counts["paged_attn_call"] == 0
              and counts["decode_write_attend_call"] == 0,
              f"{tag}: the slot engine launched the paged attention kernel")
        return counts, [r.output for r in reqs]

    def slot_pair(mod, step_params, step_cfg, prompt):
        """One per-request prefill of `prompt`, spliced into slot 1 of a
        4-slot cache of max_len 256, and one decode step for all 4 slots;
        (the two logits, the batched cache)."""
        toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
        l1, rcache = mod.prefill(step_params, {"tokens": toks}, step_cfg,
                                 max_len=256)
        cache = splice(mod.init_cache(step_cfg, 4, 256, device=dev), rcache,
                       1)
        nxt = torch.from_numpy(np.random.RandomState(10).randint(
            0, step_cfg.vocab, (4, 1))).to(dev)
        l2, cache = mod.decode_step(step_params, nxt, cache, step_cfg)
        return (l1, l2), cache

    def serve_slots(tag):
        """Phase 3's 8 requests through a fresh slot-engine Server at phase
        3's width: B1 169 times per decode step and per prefill. Returns
        (the server, the counts, the streams)."""
        server = Server(params, cfg, slot_serving, device=dev)
        counts, streams = slot_serve(server, prompts, tag,
                                     "cim_mvm_grouped_packed", 169)
        return server, counts, streams

    server, counts_3l, streams_l = serve_slots("phase 3l: slot engine run 1")
    log(f"phase 3l ({card}): B1 launches on the slot path "
        f"{counts_3l['cim_mvm_grouped_packed']}")

    # one per-request prefill (the 96-token prompt, spliced into slot 1)
    # and one decode step at the shared position, kernels vs plain
    build.reset_launch_counts()
    l_k, c_k = slot_pair(transformer, server.params, server.cfg, prompts[0])
    torch.cuda.synchronize()
    s_counts = build.launch_counts()
    l_p, c_p = slot_pair(transformer, server.params, server.cfg.replace(
        cim=dataclasses.replace(server.cfg.cim, backend="plain")), prompts[0])
    torch.cuda.synchronize()
    check(l_k[0].shape == (1, cfg.vocab) and l_k[1].shape == (4, cfg.vocab)
          and all(bool(torch.isfinite(a).all()) for a in l_k),
          "phase 3l: slot prefill / decode logits malformed")
    s_err = max((a - b).abs().max().item() for a, b in zip(l_k, l_p))
    same_cache = int(c_k["pos"]) == int(c_p["pos"]) == len(prompts[0]) + 1 \
        and all(
            torch.equal(c_k["layers"][n].view(torch.int16),
                        c_p["layers"][n].view(torch.int16))
            for n in ("k", "v"))
    log(f"phase 3l: slot prefill T={len(prompts[0])} + decode step, CIM "
        f"backend cuda_packed vs plain: max |dlogit| = {s_err}, caches "
        f"identical: {same_cache} (tolerance 0); launches {s_counts}")
    check(s_err == 0.0 and same_cache, "phase 3l: kernel and plain slot "
          "prefill / decode steps differ")
    check(s_counts["cim_mvm_grouped_packed"] == 2 * 169,
          f"phase 3l: the two steps launched B1 "
          f"{s_counts['cim_mvm_grouped_packed']} times, expected 338")
    del l_k, l_p, c_k, c_p

    # the slot decode step on the card vs eager (4 slots at pos 100)
    scache = transformer.init_cache(server.cfg, 4, 256, device=dev)
    scache["pos"].fill_(100)
    stok = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab, (4, 1))).to(dev)

    def slot_decode_step():
        transformer.decode_step(server.params, stok, scache, server.cfg)

    decode_breakdown(server, f"phase 3l ({card}): slot engine",
                     slot_decode_step)
    build.reset_launch_counts()
    slot_decode_step()
    torch.cuda.synchronize()
    log(f"phase 3l: launches of one slot decode step "
        f"{build.launch_counts()}")
    del scache

    # B1 at M = 96: a 96-token per-request prefill's 168 layer MVMs
    pre96 = {"ms": 0.0, "bytes": 0.0, "ops": 0.0}
    m96 = len(prompts[0])
    for label, k, n, count in DECODE_MVMS[:-1]:
        x = codes((m96, k))
        ws = copies(ops.pack_codes(codes((k, n))).contiguous())
        t_k = graph_ms(torch, lambda a, b_: cm.cim_mvm_grouped_packed(
            a, b_, **kw), [(x, wi) for wi in ws])
        log(f"  B1 {label:12s} M={m96} K={k} N={n} x{count}/prefill: "
            f"kernel {t_k * 1e3:.2f} us on the card")
        pre96["ms"] += count * t_k
        pre96["bytes"] += count * (ws[0].numel() + m96 * k * 4
                                   + m96 * n * 4)
        pre96["ops"] += count * 2 * m96 * k * n
        del x, ws
    b96 = (pre96["bytes"] / HBM_BYTES_S * 1e3, pre96["ops"] / INT_OP_S * 1e3)
    log(f"phase 3l ({card}): B1 one {m96}-token prefill's 168 layer MVMs at "
        f"M={m96}: kernel {pre96['ms']:.3f} ms on the card, bound "
        f"{max(b96):.3f} ms (bytes {b96[0]:.3f} ms, operations "
        f"{b96[1]:.3f} ms)")
    del server
    server_l2, _, streams_l2 = serve_slots("phase 3l: slot engine run 2")
    check(streams_l2 == streams_l, "phase 3l: two same-seed slot serves "
          "gave different streams")
    log("phase 3l: the two slot serves gave identical streams")

    # the model drafter sharing the target's weights, smoke size, --cim off:
    # the paged spec Server against plain greedy on the same requests
    scfg = SMOKES["internlm2-1.8b"].replace(dtype="float32")
    sparams = registry.init_params(scfg, seed=0, device=dev)
    srng = np.random.RandomState(77)
    sprompts = [srng.randint(0, scfg.vocab, size=int(n)).tolist()
                for n in srng.randint(8, 49, size=8)]
    spec_out = {}
    for leg, kw_ in (("plain", {}), ("model drafter",
                                     dict(drafter="model:internlm2-1.8b",
                                          spec_k=SPEC_K))):
        srv = Server(sparams, scfg, ServingConfig(
            paged=True, attn="kernel", n_slots=4, max_len=128, **kw_),
            device=dev)
        if srv.drafter is not None:
            check(isinstance(srv.drafter, ModelDrafter),
                  "phase 3l: model:internlm2-1.8b built no ModelDrafter")
            srv.drafter.params = sparams      # share the target's weights
        reqs = [Request(prompt=p, max_new_tokens=16) for p in sprompts]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        for r in reqs:
            check(len(r.output) == 16 and all(0 <= t < scfg.vocab
                                              for t in r.output),
                  f"phase 3l: {leg} req{r.rid}: bad output {r.output}")
        m = srv.metrics.summary()
        spec_out[leg] = [r.output for r in reqs]
        log(f"phase 3l ({card}): smoke-size paged serve, {leg}: 128 tokens "
            f"in {m['steps']} steps, {dt:.2f} s ({128 / dt:.1f} tok/s); "
            f"spec_steps={m['spec_steps']} draft_tokens={m['draft_tokens']} "
            f"accept_rate={m['accept_rate']:.4f} mean_accept_len="
            f"{m['mean_accept_len']:.4f} accept_hist={m['accept_hist']}")
        if leg == "plain":
            plain_steps = m["steps"]
        else:
            check(m["draft_accepted"] > 0, "phase 3l: the model drafter "
                  "sharing the target's weights had no draft accepted")
            same = sum(a == b for a, b in zip(spec_out["plain"],
                                              spec_out[leg]))
            log(f"phase 3l ({card}): target steps plain / spec = "
                f"{plain_steps} / {m['steps']} = "
                f"{plain_steps / m['steps']:.3f}; streams equal to plain "
                f"greedy in {same} of 8 requests")
        del srv
    del sparams

    # ---- phase "dryrun": the lowering analysis on phase 3l's model -------
    phase_dryrun(torch, np, dev, card, server_l2)
    del server_l2

    # ---- phase 3p: calibrated static grids and precision manifests -------
    # (a) the reference launcher's calibration batch (RandomState(7), 2 x 16
    # tokens) through the eager einsum forward: the whole-model grid and
    # the per-site tree
    from repro_torch.analysis import calibrate as calib
    from repro_torch.analysis import precision_search as psearch
    from repro_torch.core import quant
    from repro_torch.core.cim_matmul import resolve_site_cfg
    from repro_torch.core.energy import mvm_energy
    cal_tokens = np.random.RandomState(7).randint(0, cfg.vocab, size=(2, 16))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    grid = calib.calibrate_act_scale(params, cal_tokens, cfg)
    t_grid = time.monotonic() - t0
    t0 = time.monotonic()
    tree = calib.calibrate_act_tree(params, cal_tokens, cfg)
    t_tree = time.monotonic() - t0
    check(len(grid["spans"]) == 7 * cfg.n_layers
          and math.isfinite(grid["scale"]) and grid["scale"] > 0,
          f"phase 3p: calibration recorded {len(grid['spans'])} spans, "
          f"scale {grid['scale']}")
    log(f"phase 3p ({card}): calibrate_act_scale {t_grid:.2f} s: static "
        f"grid scale={grid['scale']!r} zero_point={grid['zero_point']} "
        f"(max span {grid['span']:.6f} over {len(grid['spans'])} matmuls); "
        f"calibrate_act_tree {t_tree:.2f} s")
    for name, e in tree["sites"].items():
        log(f"  site {name}: k={e['k']} m={e['m']} rows={e['rows']} "
            f"calls={e['calls']} lo={e['lo']:.6f} hi={e['hi']:.6f} "
            f"span={e['span']:.6f} scale={e['scale']!r} zp={e['zero_point']}")
    check(sorted(tree["sites"]) == sorted(
        ["wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down"])
        and all(e["calls"] == cfg.n_layers for e in tree["sites"].values()),
        "phase 3p: the calibration tree's sites are not the 7 weight names "
        "with one call per layer")

    # (b) the search with the reference test's cheap settings, at full depth
    torch.cuda.synchronize()
    t0 = time.monotonic()
    searched = psearch.search(params, cal_tokens, cfg, seed=0,
                              bit_candidates=(7.0,), try_per_channel=False)
    t_search = time.monotonic() - t0
    sm = searched["metrics"]
    man_path = ROOT / "build" / "phase3p_manifest.json"
    man_path.parent.mkdir(parents=True, exist_ok=True)
    psearch.save_manifest(str(man_path), searched)
    log(f"phase 3p ({card}): search (bit_candidates (7.0,), no per-channel "
        f"retry, {cfg.n_layers} layers) {t_search:.2f} s: energy_win "
        f"{sm['energy_win']!r} kl_uniform {sm['kl_uniform']!r} kl_proxy "
        f"{sm['kl_proxy']!r} uniform {sm['uniform_pj_per_token']!r} / mixed "
        f"{sm['mixed_pj_per_token']!r} pJ per token; levels "
        + str({n: e["adc_levels"] for n, e in searched["sites"].items()}))
    check(sm["mixed_pj_per_token"] <= sm["uniform_pj_per_token"]
          and math.isfinite(sm["kl_proxy"])
          and sm["kl_proxy"] <= sm["kl_uniform"] + sm["kl_budget"] + 1e-9,
          "phase 3p: the search broke its energy or KL contract")

    # (c) three serves, --paged --cim bp-prequant: the static grid, the
    # searched manifest, the committed manifest
    committed = str(ROOT / "precision_manifest.json")
    legs_3p = {"static grid": dict(act_scale=grid["scale"],
                                   act_zero_point=grid["zero_point"]),
               "searched manifest": dict(precision_manifest=str(man_path)),
               "committed manifest": dict(precision_manifest=committed)}
    servers_3p = {}
    for leg, extra in legs_3p.items():
        srv = Server(params, cfg, dataclasses.replace(serving, **extra),
                     device=dev)
        check(bool(srv.cfg.cim.site_overrides) == (leg != "static grid"),
              f"phase 3p: {leg}: the manifest was not applied")
        KERNEL_COUNTERS.reset()
        counts, _ = serve_mix(srv, prompts, f"phase 3p: {leg}")
        b1 = counts["cim_mvm_grouped_packed"]
        check(b1 == 169 * srv.steps_run and counts["paged_attn_call"] > 0
              and counts["decode_write_attend_call"] > 0,
              f"phase 3p: {leg}: {b1} B1 launches in {srv.steps_run} steps "
              "(169 a step expected), or B3 / the decode launch missing")
        energy = KERNEL_COUNTERS.snapshot()["site_energy"]
        parts = []
        for name, rec in sorted(energy.items()):
            k_site = (tree["sites"][name]["k"] if name in tree["sites"]
                      else cfg.d_model)
            uniform = mvm_energy(cfg.cim.macro, k_site).e_mvm_j * rec["dots"]
            parts.append(f"{name} {rec['energy_j']!r} J over {rec['dots']} "
                         f"dots in {rec['calls']} calls (uniform 362 levels "
                         f"{uniform!r} J)")
        log(f"phase 3p ({card}): {leg}: site_energy " + "; ".join(parts))
        servers_3p[leg] = srv

    # (d) one prefill and one decode step under the searched manifest and
    # under the committed one, kernels vs plain: logits and pools identical
    def two_steps_pools(step_params, step_cfg):
        cache = transformer.init_paged_cache(step_cfg, 4 * 16 + 1, 16,
                                             device=dev)
        tb = torch.arange(1, 65, dtype=torch.int32, device=dev).reshape(4, 16)
        srng = np.random.RandomState(7)
        toks = torch.from_numpy(srng.randint(0, cfg.vocab, (4, 16))).to(dev)
        valid = torch.tensor([16, 16, 9, 0], device=dev)
        l1, cache = transformer.paged_step(
            step_params, toks, cache, tb, torch.zeros(4, device=dev,
                                                      dtype=torch.long),
            valid, step_cfg)
        nxt = torch.from_numpy(srng.randint(0, cfg.vocab, (4, 1))).to(dev)
        l2, cache = transformer.paged_step(
            step_params, nxt, cache, tb, valid,
            torch.tensor([1, 1, 1, 0], device=dev), step_cfg)
        return (l1, l2), cache["layers"]

    for leg in ("searched manifest", "committed manifest"):
        srv = servers_3p[leg]
        build.reset_launch_counts()
        l_k, pools_k = two_steps_pools(srv.params, srv.cfg)
        torch.cuda.synchronize()
        st_counts = build.launch_counts()
        l_p, pools_p = two_steps_pools(srv.params, srv.cfg.replace(
            attn_backend="plain",
            cim=dataclasses.replace(srv.cfg.cim, backend="plain")))
        torch.cuda.synchronize()
        check(all(a.shape == (4, cfg.vocab) and bool(torch.isfinite(a).all())
                  for a in l_k), f"phase 3p: {leg}: step logits malformed")
        m_err = max((a[:3] - b[:3]).abs().max().item()
                    for a, b in zip(l_k, l_p))
        same_pools = all(torch.equal(pools_k[n][:, 1:].view(torch.int16),
                                     pools_p[n][:, 1:].view(torch.int16))
                         for n in ("k", "v"))
        log(f"phase 3p: {leg}: paged_step prefill C=16 + decode C=1, "
            f"kernels vs plain versions: max |dlogit| = {m_err}, pools "
            f"identical: {same_pools} (tolerance 0); launches {st_counts}")
        check(m_err == 0.0 and same_pools, f"phase 3p: {leg}: kernel and "
              "plain steps differ")
        check(st_counts["cim_mvm_grouped_packed"] == 2 * 169,
              f"phase 3p: {leg}: the two steps launched B1 "
              f"{st_counts['cim_mvm_grouped_packed']} times, expected 338")
        del l_k, l_p, pools_k, pools_p

    # (e) under the static grid a probe's stream does not depend on its
    # companions (the reference's test_static_scale_decouples_lane_from_
    # batch, at full width)
    probe_out = []
    for companions in ((), (1, 2, 3)):
        srv = Server(params, cfg, dataclasses.replace(
            serving, **legs_3p["static grid"]), device=dev)
        probe = Request(prompt=prompts[5], max_new_tokens=16)
        srv.submit(probe)
        for i in companions:
            srv.submit(Request(prompt=prompts[i], max_new_tokens=16))
        srv.run_until_drained()
        probe_out.append(probe.output)
        del srv
    log(f"phase 3p: static grid, probe (prompt_len {len(prompts[5])}) alone "
        f"-> {probe_out[0]}; beside 3 companions -> {probe_out[1]}")
    check(probe_out[0] == probe_out[1] and len(probe_out[0]) == 16,
          "phase 3p: under the static grid the probe's stream depends on its "
          "companions")

    # (f) the host cost of site resolution in one decode step (169 calls
    # of resolve_site_cfg in the step's site order, cached per (cfg,
    # site)), and the manifest decode step on the card vs eager
    srv = servers_3p["committed manifest"]
    step_sites = ["wq", "wk", "wv", "wo", "w_up", "w_gate",
                  "w_down"] * cfg.n_layers + ["head"]
    reps = 200
    t0 = time.perf_counter()
    for _ in range(reps):
        for site in step_sites:
            with quant.act_site(site):
                resolve_site_cfg(srv.cfg.cim)
    res_us = (time.perf_counter() - t0) / reps * 1e6
    t0 = time.perf_counter()
    for _ in range(reps):
        for site in step_sites:
            with quant.act_site(site):
                pass
    scope_us = (time.perf_counter() - t0) / reps * 1e6
    log(f"phase 3p ({card}): site resolution {res_us:.1f} us of host per "
        f"decode step (169 resolve_site_cfg calls inside their act_site "
        f"scopes; the scopes alone {scope_us:.1f} us)")
    decode_breakdown(srv, f"phase 3p ({card}): committed manifest")
    decode_breakdown(servers_3p["static grid"],
                     f"phase 3p ({card}): static grid")
    del servers_3p, srv

    # ---- phase 4: --cim bp serve (B2) ------------------------------------
    server = Server(params, cfg, ServingConfig(
        paged=True, attn="kernel", n_slots=4, max_len=256,
        prefill_chunk=16), device=dev)
    counts = short_serve(server, prompts, "phase 4: --cim bp")
    main_launches["B2"] = counts["cim_mvm_grouped"]
    check(main_launches["B2"] > 0, "B2 was not launched on the --cim bp path")
    decode_breakdown(server, "phase 4: --cim bp")
    del server

    # ---- phase 4b: the seeded NOISY converter (B6, then B5) --------------
    # built as the reference's serve.py --cim bp-noisy builds it
    noisy = CIMConfig(enabled=True, noise_seed=0)
    noisy = dataclasses.replace(noisy, macro=dataclasses.replace(
        noisy.macro, sim_level=SimLevel.NOISY))
    ncfg = cfg.replace(cim=noisy)
    server = Server(params, ncfg, serving, device=dev)
    counts, _ = serve_mix(server, prompts, "phase 4b: NOISY prequant")
    for name, n in (("B6", counts["cim_mvm_grouped_noisy_packed"]),
                    ("B3", counts["paged_attn_call"]),
                    ("B3+B4", counts["decode_write_attend_call"])):
        check(n > 0, f"{name} was not launched on the NOISY prequant serve")
    main_launches["B6"] = counts["cim_mvm_grouped_noisy_packed"]
    check_steps(server, "phase 4b: NOISY prequant")
    decode_breakdown(server, "phase 4b: NOISY prequant")
    del server
    server = Server(params, ncfg, ServingConfig(
        paged=True, attn="kernel", n_slots=4, max_len=256,
        prefill_chunk=16), device=dev)
    counts = short_serve(server, prompts, "phase 4b: --cim bp-noisy")
    main_launches["B5"] = counts["cim_mvm_grouped_noisy"]
    check(main_launches["B5"] > 0,
          "B5 was not launched on the --cim bp-noisy path")
    del server

    # ---- phases "tune" and "mesh" (phase 3's model and settings) ---------
    phase_tune_mesh(torch, np, dev, card, types.SimpleNamespace(
        params=params, cfg=cfg, serving=serving, prompts=prompts, kw=kw,
        codes=codes, serve_mix=serve_mix, check_steps=check_steps,
        short_serve=short_serve))

    # ---- phase 5: macro depths other than 144 -----------------------------
    # B2/B5 take every depth the reference takes, B1/B6 every even one;
    # each against its plain version at a layer width
    for n_rows in DEPTHS:
        dkw = dict(n_rows=n_rows, levels=362, gain=1.0,
                   full_scale=225.0 * n_rows)
        dnkw = dict(dkw, sigma=noisy_kw["sigma"])
        for m in (4, 64):
            x, w = codes((m, 2048)), codes((2048, 2048))
            where = f"at n_rows={n_rows} M={m} K=N=2048"
            y2 = cm.cim_mvm_grouped(x, w, **dkw)
            y5 = cm.cim_mvm_grouped_noisy(x, w, seeds[7], **dnkw)
            check(torch.equal(y2, cm.cim_mvm_grouped_plain(x, w, **dkw)),
                  f"B2 differs from its plain version {where}")
            check(torch.equal(y5, cm.cim_mvm_grouped_noisy_plain(
                x, w, seeds[7], **dnkw)),
                f"B5 differs from its plain version {where}")
            if n_rows % 2 == 0:
                wp = ops.pack_codes(w).contiguous()
                check(torch.equal(cm.cim_mvm_grouped_packed(x, wp, **dkw),
                                  y2), f"B1 differs from B2 {where}")
                y6 = cm.cim_mvm_grouped_noisy_packed(x, wp, seeds[7], **dnkw)
                check(torch.equal(y6, y5), f"B6 differs from B5 {where}")
            torch.cuda.synchronize()
            del x, w, y2, y5
    log(f"phase 5: B2, B5 bit-exact vs plain at n_rows {DEPTHS}, M in "
        "{4, 64}, K=N=2048 (NOISY seed 7; tolerance 0); B1 == B2 and B6 == "
        "B5 at the even depths")

    # ---- shared by phases 3m and 3d --------------------------------------
    def expert_mvms(tag, n_exp, cap, shapes, specs, make_w):
        """Each expert-batched kernel of `specs` ((id, kernel, plain, 2-D
        wrapper, stochastic kw)) at E = n_exp experts of capacity `cap`,
        one layer's projections `shapes` ((label, K, N, launches per
        layer)), weights from make_w(K, N): bit-exact against its plain
        version and against n_exp 2-D launches (the stochastic ones at
        seeds 0 and 7), then timed against the bound of its bytes or its
        operations; the results go to `report`."""
        for kid, kern, plain, two_d, nkw in specs:
            t_kid = time.monotonic()
            fkw = nkw or kw
            tot = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0,
                   "hash_ops": 0.0}
            e_err = 0.0
            for label, k, n, count in shapes:
                x = codes((n_exp, cap, k))
                w = make_w(k, n)
                for sd in ((0, 7) if nkw else (None,)):
                    extra = () if sd is None else (seeds[sd],)
                    y = kern(x, w, *extra, **fkw)
                    yp = plain(x, w, *extra, **fkw)
                    y2 = torch.stack([two_d(x[i], w[i], *extra, **fkw)
                                      for i in range(n_exp)])
                    torch.cuda.synchronize()
                    where = f"at E={n_exp} C={cap} K={k} N={n}" \
                        + ("" if sd is None else f" seed {sd}")
                    check(torch.equal(y, yp), f"{kid} differs from its "
                          f"plain version {where}")
                    check(torch.equal(y, y2), f"{kid} differs from "
                          f"{n_exp} 2-D launches {where}")
                    e_err = max(e_err, (y - yp).abs().max().item())
                    del y, yp, y2
                extra = (seeds[0],) if nkw else ()

                def run_k(a, b):
                    return kern(a, b, *extra, **fkw)

                def run_p(a, b):
                    return plain(a, b, *extra, **fkw)

                ws = copies(w)
                args = [(x, wi) for wi in ws]
                t_k = graph_ms(torch, run_k, args)
                t_p = graph_ms(torch, run_p, args[:2], reps=3,
                               min_iters=len(args[:2]))
                wbytes = w.numel() * w.element_size()
                rows = n_exp * cap
                log(f"  {kid} {label:12s} E={n_exp} C={cap} K={k} N={n} "
                    f"x{count}/layer: kernel {t_k * 1e3:.2f} us on the card "
                    f"({wbytes / (t_k * 1e-3) / 1e12:.3f} TB/s of "
                    f"{wbytes / 1e6:.2f} MB weights), plain "
                    f"{t_p * 1e3:.2f} us")
                tot["ms"] += count * t_k
                tot["plain_ms"] += count * t_p
                tot["bytes"] += count * (wbytes + rows * k * 4 + rows * n * 4)
                tot["ops"] += count * 2 * rows * k * n
                if nkw:
                    tot["hash_ops"] += count * rows * n * (
                        -(-k // kw["n_rows"]) * HASH_OPS_PER_CONVERSION
                        + HASH_OPS_PER_OUTPUT)
                del x, w, ws, args
                torch.cuda.empty_cache()
            b_bytes = tot["bytes"] / HBM_BYTES_S * 1e3
            b_ops = max(tot["ops"] / INT_OP_S,
                        tot["hash_ops"] / INT32_OP_S) * 1e3
            report[kid] = dict(
                ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=max(b_bytes, b_ops),
                bound_by="bytes" if b_bytes >= b_ops else "operations",
                library_ms=None, max_abs_err=e_err)
            log(f"{tag}: {kid} bit-exact vs its plain version and vs "
                f"{n_exp} 2-D launches" + (" (seeds 0 and 7)" if nkw else "")
                + f"; one layer's {sum(c for *_, c in shapes)} expert MVMs: "
                f"kernel {tot['ms']:.3f} ms on the card, plain "
                f"{tot['plain_ms']:.3f} ms, bound {max(b_bytes, b_ops):.3f} "
                f"ms (bytes {b_bytes:.3f} ms, operations {b_ops:.3f} ms, "
                f"hash {tot['hash_ops'] / 1e9:.3f} G int32 ops); "
                f"{time.monotonic() - t_kid:.1f} s")

    def packed_gb(tree):
        """GB of the stored (nibble-packed) codes in a params tree."""
        if isinstance(tree, dict):
            return sum(v.numel() * v.element_size() / 1e9 if k.endswith("_q")
                       else packed_gb(v) for k, v in tree.items())
        if isinstance(tree, list):
            return sum(packed_gb(v) for v in tree)
        return 0.0

    def image_prefill(server):
        """A VLM's slot-engine prefill: numpy-seeded image_embeds [1,
        n_image_tokens, D] in front of 32 text tokens, kernels vs plain:
        identical logits and K/V; B1 launched once per dense call."""
        vcfg = server.cfg
        irng = np.random.RandomState(11)
        img = torch.from_numpy(irng.standard_normal(
            (1, vcfg.n_image_tokens, vcfg.d_model)).astype(np.float32)
            * 0.02).to(dev)
        toks = torch.from_numpy(irng.randint(0, vcfg.vocab, (1, 32))).to(dev)
        batch = {"tokens": toks, "image_embeds": img}
        t0 = time.monotonic()
        build.reset_launch_counts()
        l_k, c_k = transformer.prefill(server.params, batch, vcfg,
                                       max_len=512)
        torch.cuda.synchronize()
        i_counts = build.launch_counts()
        l_p, c_p = transformer.prefill(server.params, batch, vcfg.replace(
            cim=dataclasses.replace(vcfg.cim, backend="plain")), max_len=512)
        torch.cuda.synchronize()
        t_len = vcfg.n_image_tokens + 32
        check(l_k.shape == (1, vcfg.vocab) and bool(torch.isfinite(l_k).all())
              and int(c_k["pos"]) == t_len,
              f"{vcfg.arch}: image-prefix prefill malformed")
        i_err = (l_k - l_p).abs().max().item()
        same = all(torch.equal(c_k["layers"][n].view(torch.int16),
                               c_p["layers"][n].view(torch.int16))
                   for n in ("k", "v"))
        per_fwd = 7 * vcfg.n_layers + 1
        log(f"phase 3m: {vcfg.arch} slot prefill of {vcfg.n_image_tokens} "
            f"image embeddings + 32 tokens (T = {t_len}), kernels vs plain "
            f"versions: max |dlogit| = {i_err}, K/V identical: {same} "
            f"(tolerance 0); {time.monotonic() - t0:.1f} s; launches "
            f"{i_counts}")
        check(i_err == 0.0 and same, f"phase 3m: {vcfg.arch}'s kernel and "
              "plain image-prefix prefills differ")
        check(i_counts["cim_mvm_grouped_packed"] == per_fwd,
              f"phase 3m: {vcfg.arch}'s image-prefix prefill launched B1 "
              f"{i_counts['cim_mvm_grouped_packed']} times, expected "
              f"{per_fwd}")

    # ---- phase 3m: the MoE family at full width (qwen2-moe-a2.7b) ---------
    del params
    torch.cuda.empty_cache()
    # (a) the expert-batched B1 / B6 at the decode shapes: 64 experts
    # (60 padded to 64) of capacity 8, one layer's three projections
    expert_mvms(
        "phase 3m", MOE_EXPERTS, MOE_CAPACITY, MOE_MVMS,
        (("B1e", cm.cim_mvm_grouped_packed_experts,
          cm.cim_mvm_grouped_packed_experts_plain,
          cm.cim_mvm_grouped_packed, {}),
         ("B6e", cm.cim_mvm_grouped_noisy_packed_experts,
          cm.cim_mvm_grouped_noisy_packed_experts_plain,
          cm.cim_mvm_grouped_noisy_packed, noisy_kw)),
        lambda k, n: ops.pack_codes(codes((MOE_EXPERTS, k, n))).contiguous())

    # (b) the model: initialised and quantized layer by layer, so its float
    # weights (~30 GB in bf16) are never held whole
    mcfg = ARCHS["qwen2-moe-a2.7b"].replace(cim=CIMConfig(enabled=True))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    mparams = registry.init_params(
        mcfg, seed=0, device=dev,
        layer_fn=lambda lp: quantize_params(lp, mcfg))
    mserver = Server(mparams, mcfg, serving, device=dev)
    del mparams
    torch.cuda.synchronize()
    e_bytes = sum(lp["ffn"][n + "_q"].numel()
                  for lp in mserver.params["layers"]
                  for n in ("e_gate", "e_up", "e_down"))
    log(f"phase 3m: {mcfg.arch} full width ({mcfg.n_layers} layers, d_model "
        f"{mcfg.d_model}, {mcfg.moe.n_experts} routed experts padded to "
        f"{moe.padded_experts(mcfg.moe.n_experts)}, top-{mcfg.moe.top_k}, "
        f"{mcfg.moe.n_shared} gated shared experts of width "
        f"{mcfg.moe.d_ff_shared}, vocab {mcfg.vocab}) initialised and "
        f"quantized layer by layer in {time.monotonic() - t0:.1f} s: "
        f"{e_bytes / 1e9:.3f} GB of packed expert codes, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # (c) a prefill chunk and a decode step, kernels vs plain
    check_steps(mserver, "phase 3m", M_PLAIN_LAYERS)
    # (d) phase 3's 8 requests, IDEAL, then NOISY (noise_seed 0) twice
    counts, streams_i = serve_mix(mserver, prompts, "phase 3m: IDEAL",
                                  new_tokens=SHORT_NEW_TOKENS)
    counts_i = counts
    for name, n in (("B1", counts["cim_mvm_grouped_packed"]),
                    ("B1e", counts["cim_mvm_grouped_packed_experts"]),
                    ("B3", counts["paged_attn_call"]),
                    ("B3+B4", counts["decode_write_attend_call"])):
        check(n > 0, f"{name} was not launched on the MoE serve")
    main_launches["B1e"] = counts["cim_mvm_grouped_packed_experts"]
    decode_breakdown(mserver, f"phase 3m ({card}): IDEAL")
    nserver = Server(mserver.params, mcfg.replace(cim=noisy), serving,
                     device=dev)
    counts, streams_n = serve_mix(nserver, prompts, "phase 3m: NOISY run 1",
                                  new_tokens=SHORT_NEW_TOKENS)
    counts_n = counts
    for name, n in (("B6", counts["cim_mvm_grouped_noisy_packed"]),
                    ("B6e", counts["cim_mvm_grouped_noisy_packed_experts"]),
                    ("B3", counts["paged_attn_call"]),
                    ("B3+B4", counts["decode_write_attend_call"])):
        check(n > 0, f"{name} was not launched on the NOISY MoE serve")
    main_launches["B6e"] = counts["cim_mvm_grouped_noisy_packed_experts"]
    check_steps(nserver, "phase 3m: NOISY", M_PLAIN_LAYERS)
    decode_breakdown(nserver, f"phase 3m ({card}): NOISY")
    del nserver
    nserver = Server(mserver.params, mcfg.replace(cim=noisy), serving,
                     device=dev)
    _, streams_n2 = serve_mix(nserver, prompts, "phase 3m: NOISY run 2",
                              new_tokens=SHORT_NEW_TOKENS)
    check(streams_n2 == streams_n, "phase 3m: two same-seed NOISY serves "
          "gave different streams")
    log("phase 3m: the two same-seed NOISY serves gave identical streams")
    del nserver
    torch.cuda.empty_cache()

    # ---- phase "ep": expert parallelism and the KV-head split ------------
    ep_launches = phase_ep(torch, np, dev, card, types.SimpleNamespace(
        server=mserver, serving=serving, prompts=prompts, noisy=noisy,
        kw=kw, noisy_kw=noisy_kw, seeds=seeds, codes=codes,
        serve_mix=serve_mix, ideal=(counts_i, streams_i),
        noisy_run=(counts_n, streams_n)))
    for kid, n in ep_launches.items():
        main_launches[kid] += n
    del mserver
    torch.cuda.empty_cache()

    # (e) the dense archs: stablelm-3b (dh 80 through B3's GEN instances,
    # LayerNorm, qkv bias, rotary on a quarter of the head dim), llama3-8b
    # (GQA 32 / 8 heads of 128, vocab 128256) and granite-3-8b (the tied
    # head, embed.T through B2), both with n_layers cut to E_DEPTH, and
    # internvl2-26b's decoder (48 layers, d_model 6144, GQA 48 / 8, d_ff
    # 16384, vocab 92553; ~37.5 GB of bf16 never held whole)
    for arch in ("stablelm-3b", "llama3-8b", "granite-3-8b",
                 "internvl2-26b"):
        lcfg = ARCHS[arch].replace(cim=CIMConfig(enabled=True))
        if arch in E_DEPTH:
            lcfg = lcfg.replace(n_layers=E_DEPTH[arch])
        t0 = t_arch = time.monotonic()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lserver = Server(registry.init_params(
            lcfg, seed=0, device=dev,
            layer_fn=lambda lp, c=lcfg: quantize_params(lp, c)), lcfg,
            serving, device=dev)
        torch.cuda.synchronize()
        cut = (f" of {ARCHS[arch].n_layers}" if arch in E_DEPTH else "")
        log(f"phase 3m: {lcfg.arch} full width ({lcfg.n_layers}{cut} layers, "
            f"d_model {lcfg.d_model}, {lcfg.n_heads} / {lcfg.n_kv_heads} "
            f"heads of {lcfg.head_dim}, vocab {lcfg.vocab}) initialised and "
            f"packed in {time.monotonic() - t0:.1f} s: "
            f"{packed_gb(lserver.params):.3f} GB of packed codes, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        t0 = time.monotonic()
        build.reset_launch_counts()
        check_steps(lserver, f"phase 3m: {lcfg.arch}")
        counts = build.launch_counts()
        check(counts["paged_attn_call"] > 0
              and counts["decode_write_attend_call"] > 0
              and counts["cim_mvm_grouped_packed"] > 0,
              f"phase 3m: {lcfg.arch}'s steps did not launch B1, B3 and the "
              "decode launch")
        check(not lcfg.tie_embeddings or counts["cim_mvm_grouped"] > 0,
              f"phase 3m: {lcfg.arch}'s tied head did not launch B2")
        log(f"phase 3m: {lcfg.arch} steps kernels vs plain in "
            f"{time.monotonic() - t0:.1f} s; launches {counts}")
        if lcfg.n_image_tokens:
            image_prefill(lserver)
            decode_breakdown(lserver, f"phase 3m ({card}): {lcfg.arch}")
            log(f"phase 3m: {lcfg.arch}: {time.monotonic() - t_arch:.1f} s "
                f"in all, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del lserver
        torch.cuda.empty_cache()

    # ---- phase 3d: deepseek-v3 (MLA, leading dense layers, B2e / B5e) ----
    t3d = time.monotonic()
    # (a) the expert-batched B2 / B5 at deepseek-v3's decode shapes: 256
    # experts of capacity 8, f32 code containers of 15 GB a projection
    cgen = torch.Generator(device=dev).manual_seed(3)
    expert_mvms(
        "phase 3d", DS_EXPERTS, DS_CAPACITY, DS_MVMS,
        (("B2e", stated_width(cm.cim_mvm_grouped_experts),
          cm.cim_mvm_grouped_experts_plain, cm.cim_mvm_grouped, {}),
         ("B5e", stated_width(cm.cim_mvm_grouped_noisy_experts),
          cm.cim_mvm_grouped_noisy_experts_plain, cm.cim_mvm_grouped_noisy,
          noisy_kw)),
        lambda k, n: torch.randint(0, 16, (DS_EXPERTS, k, n), generator=cgen,
                                   device=dev, dtype=torch.float32))
    log(f"phase 3d (a): {time.monotonic() - t3d:.1f} s")

    # (b) every matrix at full width, n_layers cut to first_dense + 1: the
    # three dense layers and one MoE layer (the full model's routed experts
    # hold 654 G codes, 58 layers x 256 x 3 x 7168 x 2048)
    t0 = time.monotonic()
    full = ARCHS["deepseek-v3-671b"]
    dcfg = full.replace(n_layers=full.moe.first_dense + 1,
                        cim=CIMConfig(enabled=True))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dparams = registry.init_params(dcfg, seed=0, device=dev)
    torch.cuda.synchronize()

    def gbytes(tree):
        if isinstance(tree, dict):
            return sum(gbytes(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(gbytes(v) for v in tree)
        return tree.numel() * tree.element_size() / 1e9

    log(f"phase 3d (b): {dcfg.arch} at full width (d_model {dcfg.d_model}, "
        f"{dcfg.n_heads} heads, q / kv LoRA {dcfg.mla.q_lora_rank} / "
        f"{dcfg.mla.kv_lora_rank}, {dcfg.moe.n_experts} routed experts "
        f"top-{dcfg.moe.top_k}, d_ff_dense {dcfg.moe.d_ff_dense}, vocab "
        f"{dcfg.vocab}), n_layers cut to {dcfg.n_layers} "
        f"({dcfg.moe.first_dense} dense + 1 MoE), initialised in "
        f"{time.monotonic() - t0:.1f} s: tok {gbytes(dparams['tok']):.2f} "
        f"GB, dense layers {gbytes(dparams['dense_layers']):.2f} GB, MoE "
        f"layer {gbytes(dparams['layers']):.2f} GB, mtp "
        f"{gbytes(dparams['mtp']):.2f} GB; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    n_moe = dcfg.n_layers - dcfg.moe.first_dense
    ds_serving = ServingConfig(n_slots=4, max_len=256)
    ds_noisy = dcfg.replace(cim=noisy)

    # (c) one per-request prefill (the 96-token prompt, spliced into slot
    # 1) and one decode step, kernels vs plain, at IDEAL and NOISY
    batched = {"IDEAL": "cim_mvm_grouped_experts",
               "NOISY": "cim_mvm_grouped_noisy_experts"}
    for level, step_cfg in (("IDEAL", dcfg), ("NOISY", ds_noisy)):
        t0 = time.monotonic()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        l_k, c_k = slot_pair(transformer, dparams, step_cfg, prompts[0])
        torch.cuda.synchronize()
        s_counts = build.launch_counts()
        t_k = time.monotonic() - t0
        l_p, c_p = slot_pair(transformer, dparams, step_cfg.replace(
            cim=dataclasses.replace(step_cfg.cim, backend="plain")),
            prompts[0])
        torch.cuda.synchronize()
        check(l_k[0].shape == (1, dcfg.vocab)
              and l_k[1].shape == (4, dcfg.vocab)
              and all(bool(torch.isfinite(a).all()) for a in l_k),
              f"phase 3d: {level} prefill / decode logits malformed")
        d_err = max((a - b).abs().max().item() for a, b in zip(l_k, l_p))
        same = all(torch.equal(c_k[st]["latent"].view(torch.int16),
                               c_p[st]["latent"].view(torch.int16))
                   for st in ("dense_layers", "layers"))
        log(f"phase 3d (c): {level} prefill T={len(prompts[0])} + decode "
            f"step, kernels vs plain versions: max |dlogit| = {d_err}, "
            f"latent caches identical: {same} (tolerance 0); kernels "
            f"{t_k:.1f} s, plain {time.monotonic() - t0 - t_k:.1f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
            f"{s_counts}")
        check(d_err == 0.0 and same, f"phase 3d: {level} kernel and plain "
              "prefill / decode steps differ")
        check(s_counts[batched[level]] == 2 * 3 * n_moe,
              f"phase 3d: {level}: {s_counts[batched[level]]} expert-batched "
              f"launches in a prefill and a decode step, expected "
              f"{2 * 3 * n_moe}")
        del l_k, l_p, c_k, c_p
        torch.cuda.empty_cache()

    # (d) phase 3's 8 requests through the slot engine at --cim bp, then
    # twice at --cim bp-noisy (noise_seed 0); B2e / B5e launch 3 times per
    # MoE layer and forward (each prefill, each decode step)
    def ds_serve(step_cfg, tag):
        server = Server(dparams, step_cfg, ds_serving, device=dev)
        check(not server.paged, f"{tag}: not the slot engine")
        forwards = [0]
        inner = (transformer.prefill, transformer.decode_step)

        def counted(fn):
            def run(*a, **k):
                forwards[0] += 1
                return fn(*a, **k)
            return run

        transformer.prefill, transformer.decode_step = map(counted, inner)
        reqs = [Request(prompt=p, max_new_tokens=DS_NEW_TOKENS)
                for p in prompts]
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launch_counts()
            t0 = time.monotonic()
            for r in reqs:
                server.submit(r)
            server.run_until_drained()
            torch.cuda.synchronize()
            dt = time.monotonic() - t0
        finally:
            transformer.prefill, transformer.decode_step = inner
        counts = build.launch_counts()
        for r in reqs:
            log(f"{tag} req{r.rid}: prompt_len={len(r.prompt)} -> "
                f"{r.output}")
            check(len(r.output) == DS_NEW_TOKENS
                  and all(0 <= t < dcfg.vocab for t in r.output),
                  f"{tag} req{r.rid}: bad output {r.output}")
        total = sum(len(r.output) for r in reqs)
        log(f"{tag}: 8 requests, {total} tokens, {forwards[0]} forwards "
            f"({server.steps_run} steps), {dt:.2f} s "
            f"({total / dt:.1f} tok/s), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
            f"{counts}")
        return server, counts, forwards[0], [r.output for r in reqs]

    for level, step_cfg, runs in (("IDEAL", dcfg, 1), ("NOISY", ds_noisy, 2)):
        streams = []
        for run in range(runs):
            mode = "bp" if level == "IDEAL" else "bp-noisy"
            tag = f"phase 3d (d): --cim {mode}" \
                + (f" run {run + 1}" if runs > 1 else "")
            server, counts, fwd, out = ds_serve(step_cfg, tag)
            streams.append(out)
            kname = batched[level]
            check(counts[kname] == 3 * n_moe * fwd,
                  f"{tag}: {counts[kname]} {kname} launches in {fwd} "
                  f"forwards, expected {3 * n_moe * fwd}")
            other = batched["NOISY" if level == "IDEAL" else "IDEAL"]
            check(counts[other] == 0 and counts["paged_attn_call"] == 0,
                  f"{tag}: launched {other} or the paged attention kernel")
            if run == 0:
                main_launches["B2e" if level == "IDEAL" else "B5e"] = \
                    counts[kname]
                # the slot decode step on the card vs eager (4 slots at
                # pos 100), and its launches
                scache = transformer.init_cache(step_cfg, 4, 256,
                                                device=dev)
                scache["pos"].fill_(100)
                stok = torch.from_numpy(np.random.RandomState(8).randint(
                    0, dcfg.vocab, (4, 1))).to(dev)

                def ds_decode_step(c=step_cfg, sc=scache, st=stok):
                    transformer.decode_step(dparams, st, sc, c)

                torch.cuda.empty_cache()
                decode_breakdown(server, f"phase 3d ({card}): {level}",
                                 ds_decode_step)
                build.reset_launch_counts()
                ds_decode_step()
                torch.cuda.synchronize()
                log(f"phase 3d: {level}: launches of one slot decode step "
                    f"{build.launch_counts()}")
                del scache
            del server
            torch.cuda.empty_cache()
        if runs > 1:
            check(streams[0] == streams[1], "phase 3d: two same-seed NOISY "
                  "serves gave different streams")
            log("phase 3d: the two same-seed NOISY serves gave identical "
                "streams")
    del dparams
    torch.cuda.empty_cache()
    log(f"phase 3d: {time.monotonic() - t3d:.1f} s in all")

    # ---- phase 3r: the recurrent archs (rwkv6-7b, then zamba2-2.7b) -------
    r_serving = ServingConfig(prequant=True, packed=True, n_slots=4,
                              max_len=256)

    def dense_calls(params, rcfg):
        """B1 / B6 launches of one forward: one per stored matrix, the
        shared block's once per application."""
        def n_q(tree):
            if isinstance(tree, dict):
                return sum(1 if k.endswith("_q") else n_q(v)
                           for k, v in tree.items())
            if isinstance(tree, list):
                return sum(n_q(v) for v in tree)
            return 0
        apps = mamba2._n_shared_apps(rcfg) if "shared" in params else 0
        return n_q(params["layers"]) + n_q(params["tok"]) \
            + apps * n_q(params.get("shared", {}))

    def rec_check(tag, rmod, params, step_cfg, r_prompts, kname, per_fwd):
        """slot_pair with the kernels and with their plain versions: max
        |dlogit| 0 and every cache leaf identical; `kname` launched once
        per dense call of each forward."""
        t0 = time.monotonic()
        build.reset_launch_counts()
        l_k, c_k = slot_pair(rmod, params, step_cfg, r_prompts[0])
        torch.cuda.synchronize()
        s_counts = build.launch_counts()
        t_k = time.monotonic() - t0
        l_p, c_p = slot_pair(rmod, params, step_cfg.replace(
            cim=dataclasses.replace(step_cfg.cim, backend="plain")),
            r_prompts[0])
        torch.cuda.synchronize()
        check(l_k[0].shape == (1, step_cfg.vocab)
              and l_k[1].shape == (4, step_cfg.vocab)
              and all(bool(torch.isfinite(a).all()) for a in l_k),
              f"{tag}: prefill / decode logits malformed")
        d_err = max((a - b).abs().max().item() for a, b in zip(l_k, l_p))
        leaves = [(st, n) for st in c_k if st != "pos" for n in c_k[st]]
        same = all(torch.equal(c_k[st][n], c_p[st][n]) for st, n in leaves)
        log(f"{tag}: prefill T={len(r_prompts[0])} + decode step, kernels "
            f"vs plain versions: max |dlogit| = {d_err}, caches identical "
            f"({', '.join(f'{st}.{n}' for st, n in leaves)}): {same} "
            f"(tolerance 0); kernels {t_k:.1f} s, plain "
            f"{time.monotonic() - t0 - t_k:.1f} s; launches {s_counts}")
        check(d_err == 0.0 and same, f"{tag}: kernel and plain prefill / "
              "decode steps differ")
        check(s_counts[kname] == 2 * per_fwd,
              f"{tag}: {s_counts[kname]} {kname} launches in a prefill and "
              f"a decode step, expected {2 * per_fwd}")

    for arch in ("rwkv6-7b", "zamba2-2.7b"):
        t3r = time.monotonic()
        rcfg = ARCHS[arch].replace(cim=CIMConfig(enabled=True))
        rmod = registry.get_module(rcfg)
        r_prompts = [[t % rcfg.vocab for t in p] for p in prompts]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rserver = Server(registry.init_params(
            rcfg, seed=0, device=dev,
            layer_fn=lambda lp, c=rcfg: quantize_params(lp, c)), rcfg,
            r_serving, device=dev)
        torch.cuda.synchronize()
        per_fwd = dense_calls(rserver.params, rcfg)
        log(f"phase 3r: {arch} full width ({rcfg.n_layers} layers, d_model "
            f"{rcfg.d_model}, d_ff {rcfg.d_ff}, vocab {rcfg.vocab}, "
            f"{rcfg.ssm}) initialised and packed layer by layer in "
            f"{time.monotonic() - t3r:.1f} s: {packed_gb(rserver.params):.3f}"
            f" GB of packed codes, {per_fwd} stored matrices per forward, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        rnoisy = rcfg.replace(cim=noisy)
        # (a) a prefill and a decode step, kernels vs plain: IDEAL (B1),
        # NOISY (B6) and, for zamba2, --cim bp-noisy on float weights (B5)
        rec_check(f"phase 3r (a): {arch} IDEAL", rmod, rserver.params,
                  rcfg, r_prompts, "cim_mvm_grouped_packed", per_fwd)
        rec_check(f"phase 3r (a): {arch} NOISY", rmod, rserver.params,
                  rnoisy, r_prompts, "cim_mvm_grouped_noisy_packed",
                  per_fwd)
        if arch == "zamba2-2.7b":
            fparams = registry.init_params(rcfg, seed=0, device=dev)
            rec_check(f"phase 3r (a): {arch} --cim bp-noisy", rmod, fparams,
                      rnoisy, r_prompts, "cim_mvm_grouped_noisy", per_fwd)
            del fparams
            torch.cuda.empty_cache()
        # (b) phase 3's 8 requests at IDEAL, then twice at NOISY
        slot_serve(rserver, r_prompts, f"phase 3r (b): {arch} IDEAL",
                   "cim_mvm_grouped_packed", per_fwd,
                   new_tokens=SHORT_NEW_TOKENS)
        streams = []
        for run in (1, 2):
            nserver = Server(rserver.params, rnoisy, r_serving, device=dev)
            streams.append(slot_serve(
                nserver, r_prompts, f"phase 3r (b): {arch} NOISY run {run}",
                "cim_mvm_grouped_noisy_packed", per_fwd,
                new_tokens=SHORT_NEW_TOKENS)[1])
            del nserver
        check(streams[0] == streams[1], f"phase 3r: {arch}'s two same-seed "
              "NOISY serves gave different streams")
        log(f"phase 3r: {arch}'s two same-seed NOISY serves gave identical "
            "streams")
        # (c) the slot decode step on the card vs eager (4 slots at pos
        # 100) and its launches, at IDEAL and NOISY
        for level, step_cfg in (("IDEAL", rcfg), ("NOISY", rnoisy)):
            rcache = rmod.init_cache(step_cfg, 4, 256, device=dev)
            rcache["pos"].fill_(100)
            rtok = torch.from_numpy(np.random.RandomState(8).randint(
                0, rcfg.vocab, (4, 1))).to(dev)

            def rec_decode_step(c=step_cfg, rc=rcache, rt=rtok):
                rmod.decode_step(rserver.params, rt, rc, c)

            torch.cuda.empty_cache()
            decode_breakdown(rserver, f"phase 3r ({card}): {arch} {level}",
                             rec_decode_step)
            build.reset_launch_counts()
            rec_decode_step()
            torch.cuda.synchronize()
            log(f"phase 3r: {arch} {level}: launches of one slot decode "
                f"step {build.launch_counts()}")
            del rcache
        del rserver
        torch.cuda.empty_cache()
        log(f"phase 3r: {arch}: {time.monotonic() - t3r:.1f} s in all")

    # ---- phase 3w: whisper-large-v3 at full width and depth ---------------
    t3w = time.monotonic()
    wcfg = ARCHS["whisper-large-v3"].replace(cim=CIMConfig(enabled=True))
    wnoisy = wcfg.replace(cim=noisy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wparams = quantize_params(registry.init_params(
        wcfg, seed=0, device=dev, max_seq=W_MAX_SEQ,
        layer_fn=lambda lp: quantize_params(lp, wcfg)), wcfg)
    torch.cuda.synchronize()

    def n_codes(tree):
        """Stored codes (logical, two per packed byte) in a params tree."""
        if isinstance(tree, dict):
            return sum(2 * v.numel() if k.endswith("_q") else n_codes(v)
                       for k, v in tree.items())
        if isinstance(tree, list):
            return sum(n_codes(v) for v in tree)
        return 0

    log(f"phase 3w: {wcfg.arch} full width and depth ({wcfg.encoder_layers} "
        f"encoder + {wcfg.n_layers} decoder layers, d_model {wcfg.d_model}, "
        f"{wcfg.n_heads} heads of {wcfg.head_dim}, d_ff {wcfg.d_ff}, vocab "
        f"{wcfg.vocab}, {wcfg.encoder_len} frames, max_seq {W_MAX_SEQ}) "
        f"initialised and packed layer by layer in "
        f"{time.monotonic() - t3w:.1f} s: stored codes encoder "
        f"{n_codes(wparams['enc_layers']) / 1e6:.1f} M, decoder "
        f"{n_codes(wparams['layers']) / 1e6:.1f} M, head "
        f"{n_codes(wparams['tok']) / 1e6:.1f} M; "
        f"{packed_gb(wparams):.3f} GB packed, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    wrng = np.random.RandomState(41)
    wbatch = {"tokens": torch.from_numpy(wrng.randint(0, wcfg.vocab, (2, 4))
                                         ).to(dev),
              "frames": torch.from_numpy(wrng.standard_normal(
                  (2, wcfg.encoder_len, wcfg.d_model)).astype(np.float32)
              ).to(dev)}
    w_step = 8 * wcfg.n_layers + 1

    def cut(params, step_cfg):
        """The kernels-vs-plain runs' model: the first W_PLAIN_ENC encoder
        layers."""
        return ({**params, "enc_layers": params["enc_layers"][:W_PLAIN_ENC]},
                step_cfg.replace(encoder_layers=W_PLAIN_ENC))
    w_kname = {"IDEAL": "cim_mvm_grouped_packed",
               "NOISY": "cim_mvm_grouped_noisy_packed",
               "bp-noisy": "cim_mvm_grouped_noisy"}

    def whisper_run(params, step_cfg, steps, level, tag):
        """One prefill of wbatch, then `steps` greedy decode steps; (the
        logits, the cache leaves, the streams). With the kernels (not the
        plain versions), B1 / B6 / B5 must launch once per MVM: 6 an
        encoder layer, 10 a decoder layer and the head in the prefill,
        w_step times per decode step."""
        kernels = step_cfg.cim.backend != "plain"
        w_prefill = 6 * step_cfg.encoder_layers + 10 * step_cfg.n_layers + 1
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.monotonic()
        logit, cache = transformer.prefill(params, wbatch, step_cfg,
                                           max_len=W_MAX_SEQ)
        torch.cuda.synchronize()
        t_pre = time.monotonic() - t0
        p_counts = build.launch_counts()
        logits, toks = [logit], [logit.argmax(-1)]
        build.reset_launch_counts()
        t0 = time.monotonic()
        for _ in range(steps):
            logit, cache = transformer.decode_step(params, toks[-1][:, None],
                                                   cache, step_cfg)
            logits.append(logit)
            toks.append(logit.argmax(-1))
        torch.cuda.synchronize()
        t_dec = time.monotonic() - t0
        d_counts = build.launch_counts()
        kname = w_kname[level]
        if kernels:
            check(p_counts[kname] == w_prefill
                  and d_counts[kname] == steps * w_step,
                  f"{tag}: {kname} launched {p_counts[kname]} times in the "
                  f"prefill and {d_counts[kname]} in {steps} decode steps, "
                  f"expected {w_prefill} and {steps * w_step}")
            if step_cfg.encoder_layers == wcfg.encoder_layers:
                main_w[level] = (p_counts[kname], d_counts[kname])
        check(all(a.shape == (2, wcfg.vocab) and bool(torch.isfinite(a).all())
                  for a in logits), f"{tag}: logits malformed")
        check(tuple(cache["cross"]["k"].shape)
              == (wcfg.n_layers, 2, wcfg.encoder_len, wcfg.n_kv_heads,
                  wcfg.head_dim), f"{tag}: cross cache malformed")
        log(f"{tag}: prefill {t_pre:.2f} s, {steps} decode steps "
            f"{t_dec:.2f} s; {'kernels' if kernels else 'plain versions'}"
            + (f"; {kname} {p_counts[kname]} + {d_counts[kname]} launches"
               if kernels else ""))
        leaves = [cache[st][n] for st in ("layers", "cross")
                  for n in ("k", "v")]
        return logits, leaves, torch.stack(toks, 1).tolist()

    def whisper_same(a, b):
        """(max |dlogit|, every cache leaf identical byte for byte)."""
        err = max((x - y).abs().max().item() for x, y in zip(a[0], b[0]))
        same = all(torch.equal(x.view(torch.int16), y.view(torch.int16))
                   for x, y in zip(a[1], b[1]))
        return err, same

    main_w = {}
    # (a) IDEAL, then NOISY twice with one noise_seed; kernels vs plain
    for level, step_cfg, runs in (("IDEAL", wcfg, 1), ("NOISY", wnoisy, 2)):
        outs = [whisper_run(wparams, step_cfg, W_STEPS, level,
                            f"phase 3w (a): {level} run {r + 1}")
                for r in range(runs)]
        torch.cuda.reset_peak_memory_stats()
        cparams, ccfg = cut(wparams, step_cfg)
        cut_out = whisper_run(cparams, ccfg, W_STEPS, level,
                              f"phase 3w (a): {level} {W_PLAIN_ENC} "
                              f"encoder layers")
        plain_out = whisper_run(cparams, ccfg.replace(
            cim=dataclasses.replace(step_cfg.cim, backend="plain")),
            W_STEPS, level, f"phase 3w (a): {level} {W_PLAIN_ENC} encoder "
            f"layers, plain")
        err, same = whisper_same(cut_out, plain_out)
        log(f"phase 3w (a): {level} prefill + {W_STEPS} decode steps over "
            f"{W_PLAIN_ENC} of {wcfg.encoder_layers} encoder layers, kernels "
            f"vs plain versions: max |dlogit| = {err}, self and cross K/V "
            f"identical: {same} (tolerance 0); streams {cut_out[2]}; plain "
            f"run's peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check(err == 0.0 and same and cut_out[2] == plain_out[2],
              f"phase 3w: {level} kernel and plain runs differ")
        if runs > 1:
            err, same = whisper_same(outs[0], outs[1])
            check(err == 0.0 and same and outs[0][2] == outs[1][2],
                  "phase 3w: the two same-seed NOISY runs differ")
            log("phase 3w (a): the two same-seed NOISY runs are identical "
                "(logits, caches, streams)")
        del outs, cut_out, plain_out
        torch.cuda.empty_cache()

    # (c) where the time goes: the encoder and the prefill alone, then the
    # decode step (2 requests at pos 100) on the card vs eager
    for level, step_cfg in (("IDEAL", wcfg), ("NOISY", wnoisy)):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        transformer._encode(wparams, wbatch, step_cfg)
        torch.cuda.synchronize()
        t_enc = time.monotonic() - t0
        t0 = time.monotonic()
        _, wcache = transformer.prefill(wparams, wbatch, step_cfg,
                                        max_len=W_MAX_SEQ)
        torch.cuda.synchronize()
        log(f"phase 3w ({card}): {level} encoder ({wcfg.encoder_layers} "
            f"layers over 2 x {wcfg.encoder_len} frames, B1 / B6 at M = "
            f"{2 * wcfg.encoder_len}) {t_enc:.3f} s; whole prefill "
            f"{time.monotonic() - t0:.3f} s")
        wcache["pos"].fill_(100)
        wtok = torch.from_numpy(np.random.RandomState(8).randint(
            0, wcfg.vocab, (2, 1))).to(dev)

        def w_decode_step(c=step_cfg, wc=wcache, wt=wtok):
            transformer.decode_step(wparams, wt, wc, c)

        decode_breakdown(None, f"phase 3w ({card}): {level}",
                         w_decode_step, slots=2)
        build.reset_launch_counts()
        w_decode_step()
        torch.cuda.synchronize()
        log(f"phase 3w: {level}: launches of one decode step "
            f"{build.launch_counts()}")
        del wcache
        torch.cuda.empty_cache()
    del wparams
    torch.cuda.empty_cache()

    # (b) --cim bp-noisy from the float weights (B5): one prefill and one
    # decode step, kernels vs plain
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    fparams = registry.init_params(wcfg, seed=0, device=dev,
                                   max_seq=W_MAX_SEQ)
    torch.cuda.synchronize()
    log(f"phase 3w (b): float model {gbytes(fparams):.2f} GB (bf16) in "
        f"{time.monotonic() - t0:.1f} s")
    whisper_run(fparams, wnoisy, 1, "bp-noisy",
                "phase 3w (b): --cim bp-noisy")
    cparams, ccfg = cut(fparams, wnoisy)
    k_out = whisper_run(cparams, ccfg, 1, "bp-noisy",
                        f"phase 3w (b): --cim bp-noisy, {W_PLAIN_ENC} "
                        f"encoder layers")
    p_out = whisper_run(cparams, ccfg.replace(cim=dataclasses.replace(
        noisy, backend="plain")), 1, "bp-noisy",
        f"phase 3w (b): --cim bp-noisy, {W_PLAIN_ENC} encoder layers, plain")
    err, same = whisper_same(k_out, p_out)
    log(f"phase 3w (b): --cim bp-noisy prefill + decode step over "
        f"{W_PLAIN_ENC} of {wcfg.encoder_layers} encoder layers, kernels vs "
        f"plain versions: max |dlogit| = {err}, K/V identical: {same} "
        f"(tolerance 0); peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    check(err == 0.0 and same, "phase 3w: --cim bp-noisy kernel and plain "
          "runs differ")
    del fparams, cparams, k_out, p_out
    torch.cuda.empty_cache()
    log(f"phase 3w ({card}): launches (prefill, {W_STEPS} decode steps) "
        f"{main_w}; {time.monotonic() - t3w:.1f} s in all")

    # ---- phase 3g: the paper's KWS GRU -------------------------------------
    t3g = time.monotonic()
    gcfg = gru.gru_config(n_classes=kws_gru.N_CLASSES)
    grng = np.random.RandomState(0)
    proto = grng.standard_normal((kws_gru.N_CLASSES, kws_gru.FRAMES,
                                  144)) * 1.2
    xtr, ytr = (torch.from_numpy(a).to(dev)
                for a in kws_gru.make_kws_data(grng, proto))
    xte, yte = (torch.from_numpy(a).to(dev)
                for a in kws_gru.make_kws_data(grng, proto, n=512))
    t0 = time.monotonic()
    gp, losses = kws_gru.train(gru.init(gcfg, seed=3, device=dev), xtr, ytr,
                               gcfg, steps=300, log=lambda m: None)
    torch.cuda.synchronize()
    acc_f = kws_gru.accuracy(gp, xte, yte, gcfg)
    log(f"phase 3g ({card}): KWS GRU float training, 300 full-batch SGD "
        f"steps over 1024 x {kws_gru.FRAMES} frames in "
        f"{time.monotonic() - t0:.2f} s: loss {losses[0]:.3f} -> "
        f"{losses[-1]:.3f}, float accuracy {acc_f:.4f}")
    check(losses[-1] < losses[0] - 0.2 and acc_f > 0.9,
          "phase 3g: the GRU did not learn")
    g_runs = [("IDEAL", kws_gru.macro_cfg(gcfg, level=SimLevel.IDEAL,
                                          noise_seed=None))]
    g_runs += [(f"FULL {vdd:.2f} V {temp:+.0f} C",
                kws_gru.macro_cfg(gcfg, vdd=vdd, temp_c=temp))
               for vdd, temp in kws_gru.CORNERS]
    g_launch = {}
    for tag, ccfg in g_runs:
        gq = quantize_params(gp, ccfg)
        kname = "cim_mvm_grouped_packed" if tag == "IDEAL" \
            else "cim_mvm_grouped_noisy_packed"
        build.reset_launch_counts()
        t0 = time.monotonic()
        l_k = gru.forward(gq, xte, ccfg)
        torch.cuda.synchronize()
        t_k = time.monotonic() - t0
        g_launch[tag] = build.launch_counts()[kname]
        l_p = gru.forward(gq, xte, ccfg.replace(cim=dataclasses.replace(
            ccfg.cim, backend="plain")))
        torch.cuda.synchronize()
        acc = float((l_k.argmax(-1) == yte).float().mean())
        log(f"phase 3g: stored codes at {tag}, gain 3: accuracy {acc:.4f} "
            f"(float {acc_f:.4f}); kernels vs plain versions: max |dlogit| "
            f"= {(l_k - l_p).abs().max().item()} (tolerance 0); forward "
            f"{t_k * 1e3:.1f} ms eager, {kname} {g_launch[tag]} launches")
        check(torch.equal(l_k, l_p), f"phase 3g: {tag} kernel and plain "
              "forwards differ")
        check(g_launch[tag] == 3 * kws_gru.FRAMES + 1,
              f"phase 3g: {tag}: {g_launch[tag]} {kname} launches, expected "
              f"{3 * kws_gru.FRAMES + 1}")
    log(f"phase 3g: {time.monotonic() - t3g:.1f} s in all")

    # ---- phase 3x: training ------------------------------------------------
    train_launches = phase_train(torch, np, dev, card)
    log(f"phase 3x: B2 launches of one full-depth train step (not in the "
        f"kernels line, whose B2 count is phase 4's serve): "
        f"{train_launches['B2 per step']}")

    # ---- phase 3y: the remaining training legs -----------------------------
    legs = phase_train_legs(torch, np, dev, card)
    log(f"phase 3y: launches of one qwen2-moe Trainer step (not in the "
        f"kernels line, whose B2e count is phase 3d's serve): B2e "
        f"{legs['B2e per step']}, B2 {legs['B2 per step']}")

    # ---- phase 3f: the paper's figures and the examples ---------------------
    figs = phase_figures(torch, np, dev, card, f_bodies)
    for kid, n in figs["launches"].items():
        main_launches[kid] += n

    # ---- phase 6: report -------------------------------------------------
    meta = {
        "B1": ("cim_mvm_grouped_packed", "src/repro_torch/kernels/csrc/"
               "cim_mvm.cu", "src/repro/kernels/cim_mvm.py:331"),
        "B2": ("cim_mvm_grouped", "src/repro_torch/kernels/csrc/cim_mvm.cu",
               "src/repro/kernels/cim_mvm.py:366"),
        "B3": ("paged_attn_call", "src/repro_torch/kernels/csrc/"
               "paged_attention.cu", "src/repro/kernels/paged_attention.py:257"),
        "B4": ("decode_write_attend_call", "src/repro_torch/kernels/csrc/"
               "paged_attention.cu", "src/repro/kernels/paged_attention.py:420"),
        "B5": ("cim_mvm_grouped_noisy", "src/repro_torch/kernels/csrc/"
               "cim_mvm.cu", "src/repro/kernels/cim_mvm.py:210"),
        "B6": ("cim_mvm_grouped_noisy_packed", "src/repro_torch/kernels/"
               "csrc/cim_mvm.cu", "src/repro/kernels/cim_mvm.py:253"),
        # the reference runs B1 / B6 under jax.vmap over the routed experts
        "B1e": ("cim_mvm_grouped_packed_experts", "src/repro_torch/kernels/"
                "csrc/cim_mvm.cu", "src/repro/kernels/cim_mvm.py:331"),
        "B6e": ("cim_mvm_grouped_noisy_packed_experts", "src/repro_torch/"
                "kernels/csrc/cim_mvm.cu", "src/repro/kernels/cim_mvm.py:253"),
        # ... and B2 / B5 there for float expert weights (--cim bp, bp-noisy)
        "B2e": ("cim_mvm_grouped_experts", "src/repro_torch/kernels/csrc/"
                "cim_mvm.cu", "src/repro/kernels/cim_mvm.py:366"),
        "B5e": ("cim_mvm_grouped_noisy_experts", "src/repro_torch/kernels/"
                "csrc/cim_mvm.cu", "src/repro/kernels/cim_mvm.py:210"),
    }
    kernels = []
    for kid, (name, source, replaces) in meta.items():
        r = report[kid]
        kernels.append({"name": f"{kid} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": main_launches[kid],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    log(clock_line())
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
