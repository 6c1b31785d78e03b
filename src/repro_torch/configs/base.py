"""Configuration dataclasses for models, meshes, shapes and training.

A field-for-field copy of the reference package's `configs/base.py`, so a
configuration means the same thing in both packages. Frozen + hashable.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.cim_matmul import CIMConfig


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0              # shared experts (always-on)
    d_ff_shared: int = 0           # total shared width (n_shared × expert width)
    capacity_factor: float = 1.25
    shared_gate: bool = False      # qwen2-moe gates the shared expert path
    # expert-parallel combine: "psum" = replicated-dispatch EP (baseline,
    # works for any token count incl. decode); "a2a" = sequence-sharded
    # dispatch with static-capacity all_to_all (DeepSeek-style, §Perf)
    ep_mode: str = "psum"
    first_dense: int = 0           # leading layers with dense FFN (deepseek: 3)
    d_ff_dense: int = 0            # width of those dense layers
    router_dtype: str = "float32"  # routers stay high precision + digital


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention dims (arXiv:2412.19437)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / RWKV6 recurrent-family dims."""

    kind: str = "mamba2"           # "mamba2" | "rwkv6"
    d_state: int = 64              # mamba2 N / rwkv6 head size
    head_dim: int = 64
    expand: int = 2                # mamba2 d_inner = expand × d_model
    conv_kernel: int = 4
    chunk: int = 32                # chunked-parallel scan length
    decay_lora_rank: int = 64      # rwkv6 data-dependent decay LoRA
    dt_rank: int = 0               # 0 → heads (mamba2 uses per-head dt)
    # zamba2 hybrid: a shared transformer block applied every `shared_every`
    # SSM layers (same parameters each time — Zamba2's weight-shared design).
    shared_every: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str                      # config id, e.g. "llama3-8b"
    family: str                    # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                # 0 → d_model // n_heads
    rope_theta: float = 10000.0
    rope_pct: float = 1.0          # stablelm: partial rotary (0.25)
    pos_embed: str = "rope"        # rope | learned (whisper)
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    qkv_bias: bool = False
    mlp: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    mtp: bool = False              # deepseek multi-token prediction head
    mtp_weight: float = 0.3
    # enc-dec (whisper): encoder consumes precomputed frame embeddings (stub)
    encoder_layers: int = 0
    encoder_len: int = 0           # e.g. 1500 frames
    cross_attention: bool = False
    # vlm: image patch-embedding prefix (stub frontend)
    n_image_tokens: int = 0
    # numerics / technique
    dtype: str = "bfloat16"
    cim: CIMConfig = dataclasses.field(default_factory=CIMConfig)
    # paged-serving attention backend (kernels.paged_attention registry):
    # "auto" resolves to the Pallas flash kernel (REPRO_FORCE_JNP=1 pins
    # the exact jnp reference); "exact"/"kernel" force a backend.
    attn_backend: str = "auto"
    remat: bool = True
    remat_policy: str = "dots"     # dots | nothing (save less, recompute more)
    # causal chunked attention: unroll the q-chunk loop triangularly (skip
    # fully-masked kv blocks) up to this many q chunks; beyond it, fall back
    # to the scan² schedule with masking (≈2× causal FLOPs waste)
    attn_triangular_max: int = 8
    # §Perf: compute the training loss in sequence chunks so the [tokens,
    # vocab] logits tensor is never fully materialized (big-vocab archs:
    # llama3 128k, deepseek 129k). 1 = single pass.
    ce_chunks: int = 1
    attn_chunk: int = 1024         # chunked (flash-style) attention block
    # scan_layers=False unrolls layer loops into straight-line HLO. Needed by
    # the roofline pass: XLA cost_analysis counts a while-loop body ONCE
    # (trip count ignored), so scanned-layer FLOPs/bytes under-report by ~L×.
    # Production runs keep scan (small HLO, fast compiles); analysis cells
    # unroll. Memory analysis is taken from the scanned build.
    scan_layers: bool = True
    # Sequence parallelism for the residual stream between blocks: shard the
    # token axis over "model" where divisible (Megatron-SP layout). Saves
    # L×tokens×d_model×2B/chip of checkpointed activations.
    seq_shard: bool = True
    # §Perf: lower the TP output projections (attention wo / mlp w_down)
    # through an explicit shard_map with psum_scatter instead of letting
    # GSPMD pick (it chooses ring all-reduce ⇒ 2× the wire bytes of a
    # reduce-scatter into the sequence-parallel layout).
    tp_reduce_scatter: bool = False
    supports_long_context: bool = False  # sub-quadratic archs only

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False

    @property
    def shape(self):
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self):
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 200
    lr: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    optimizer: str = "adamw"        # adamw | adafactor
    microbatch: int = 0             # >0: gradient accumulation microbatch
    seed: int = 0
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    grad_compression: bool = False  # int8 all-reduce with error feedback
    log_every: int = 10
