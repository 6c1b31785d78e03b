"""zamba2-2.7b [hybrid] — Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    ssm=SSMConfig(kind="mamba2", d_state=64, head_dim=64, expand=2,
                  conv_kernel=4, chunk=64, shared_every=6),
    supports_long_context=True,
)

SMOKE = CONFIG.replace(n_layers=6, d_model=128, n_heads=4, n_kv_heads=4,
                       d_ff=256, vocab=512,
                       ssm=SSMConfig(kind="mamba2", d_state=16, head_dim=32,
                                     expand=2, conv_kernel=4, chunk=16,
                                     shared_every=3))
