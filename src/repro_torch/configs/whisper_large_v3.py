"""whisper-large-v3 [audio] — enc-dec transformer backbone; conv frontend is a
STUB (input_specs() provides precomputed frame embeddings) [arXiv:2212.04356].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866,
    encoder_layers=32, encoder_len=1500, cross_attention=True,
    norm="layernorm", mlp="gelu", qkv_bias=True, pos_embed="learned",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                       d_ff=256, vocab=512, encoder_layers=2, encoder_len=32,
                       attn_chunk=64)
