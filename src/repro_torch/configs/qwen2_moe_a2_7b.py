"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, rope_theta=1000000.0,
    moe=MoEConfig(
        n_experts=60, top_k=4, d_ff_expert=1408,
        n_shared=4, d_ff_shared=5632,  # 4 × 1408, sigmoid-gated
        shared_gate=True, capacity_factor=1.25,
    ),
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=64, vocab=512,
    attn_chunk=64,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=2,
                  d_ff_shared=128, shared_gate=True, capacity_factor=1.25),
)
