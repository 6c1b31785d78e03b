"""internlm2-1.8b [dense] — GQA [arXiv:2403.17297]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92544, rope_theta=1000000.0,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                       d_ff=256, vocab=512, attn_chunk=64)
