"""rwkv6-7b [ssm] — Finch, attention-free, data-dependent decay
[arXiv:2404.05892]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,  # 64 × head 64
    d_ff=14336, vocab=65536,
    ssm=SSMConfig(kind="rwkv6", d_state=64, head_dim=64, chunk=32,
                  decay_lora_rank=64),
    supports_long_context=True,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                       d_ff=256, vocab=512,
                       ssm=SSMConfig(kind="rwkv6", d_state=32, head_dim=32,
                                     chunk=16, decay_lora_rank=8))
