"""granite-3-8b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab=49155, rope_theta=10000.0, tie_embeddings=True,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                       d_ff=256, vocab=512, attn_chunk=64)
