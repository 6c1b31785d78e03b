"""internvl2-26b [vlm] — InternViT (stub frontend) + InternLM2-20B backbone
[arXiv:2404.16821].

The modality frontend is a stub: a caller passes precomputed patch
embeddings [B, n_image_tokens, d_model] (post-projector) as
batch["image_embeds"], prepended to the text sequence.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553, rope_theta=1000000.0,
    n_image_tokens=256,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                       d_ff=256, vocab=512, n_image_tokens=16, attn_chunk=64)
