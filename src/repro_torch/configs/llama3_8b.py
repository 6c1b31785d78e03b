"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, rope_theta=500000.0,
)

# Reduced same-family config for CPU smoke tests (GQA ratio preserved).
SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                       d_ff=256, vocab=512, attn_chunk=64)
