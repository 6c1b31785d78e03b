"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437].

The assigned d_ff=2048 is the routed-expert width; the first 3 layers use the
paper's dense FFN width 18432. MLA dims follow the DeepSeek-V3 report.
"""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab=129280, rope_theta=10000.0,
    moe=MoEConfig(
        n_experts=256, top_k=8, d_ff_expert=2048,
        n_shared=1, d_ff_shared=2048,
        first_dense=3, d_ff_dense=18432, capacity_factor=1.25,
    ),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    mtp=True,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, d_ff=64, vocab=512,
    attn_chunk=64,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1,
                  d_ff_shared=64, first_dense=1, d_ff_dense=256,
                  capacity_factor=1.25),
    mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
)
