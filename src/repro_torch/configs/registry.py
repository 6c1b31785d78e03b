"""Architecture registry: --arch <id> → (full CONFIG, reduced SMOKE), the
reference's ten archs, and the dry-run's cell filter."""
from __future__ import annotations

from . import (deepseek_v3_671b, granite_3_8b, internlm2_1_8b,
               internvl2_26b, llama3_8b, qwen2_moe_a2_7b, rwkv6_7b,
               stablelm_3b, whisper_large_v3, zamba2_2_7b)
from .base import SHAPES, MeshConfig, ModelConfig, ShapeConfig  # noqa: F401

_MODULES = (deepseek_v3_671b, qwen2_moe_a2_7b, llama3_8b, granite_3_8b,
            internlm2_1_8b, stablelm_3b, internvl2_26b, rwkv6_7b,
            zamba2_2_7b, whisper_large_v3)

ARCHS: dict[str, ModelConfig] = {m.CONFIG.arch: m.CONFIG for m in _MODULES}
SMOKES: dict[str, ModelConfig] = {m.CONFIG.arch: m.SMOKE for m in _MODULES}


def get(arch: str, *, smoke: bool = False) -> ModelConfig:
    table = SMOKES if smoke else ARCHS
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(table)}")
    return table[arch]


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch × shape) dry-run cell runs, and why not if skipped.

    Per the brief: long_500k needs sub-quadratic attention — skipped for pure
    softmax-attention archs (incl. MLA, which is still full softmax attention
    over the latent cache) and run for SSM/hybrid archs.
    """
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("skip: pure full-softmax-attention arch at 512k context"
                       " (sub-quadratic archs only, per brief)")
    return True, ""
