"""stablelm-3b [dense] — MHA, partial rotary, LayerNorm + qkv bias
[hf:stabilityai/stablelm-2-1_6b family]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab=50304, rope_theta=10000.0, rope_pct=0.25,
    norm="layernorm", qkv_bias=True,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                       d_ff=256, vocab=512, attn_chunk=64)
