"""Offline weight quantization for serving: float params → stored 4-bit
codes + scales, per Eq. 7's W̃ encoding.

packed=True (default) emits nibble-packed uint8 [ceil(K/2), M], two u4
codes per byte (the macro's 4-bit storage density; decode reads 1/4 the
weight bytes of bf16). packed=False emits an int8 code-per-byte container.
Embeddings, norms and biases stay float.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.core.cim_matmul import quantize_weight_offline
from repro_torch.kernels.ops import pack_codes

# dense-layer weight leaves that route through the macro
QUANTIZABLE = {
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "head",
    "w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "w_kr", "w_proj",
    "w_in", "w_out", "w_x", "w_r", "w_k", "w_v", "w_g",
    "w_z", "w_h",
    "e_gate", "e_up", "e_down",
}


def quantize_params(params, cfg: ModelConfig, *, packed: bool = True):
    """Replace quantizable float leaves `w` with `w_q` (+ `w_scale`),
    recursing through dicts and per-layer lists."""
    if isinstance(params, list):
        return [quantize_params(p, cfg, packed=packed) for p in params]
    if not isinstance(params, dict):
        return params
    out = {}
    for k, v in params.items():
        if isinstance(v, (dict, list)):
            out[k] = quantize_params(v, cfg, packed=packed)
        elif k in QUANTIZABLE and getattr(v, "ndim", 0) >= 2:
            with quant.act_site(k):
                codes, scale = quantize_weight_offline(v, cfg.cim)
            out[k + "_q"] = pack_codes(codes) if packed else codes
            out[k + "_scale"] = scale
        else:
            out[k] = v
    return out


def abstract_quantized_params(params_abs, cfg: ModelConfig, *,
                              packed: bool = True):
    """`quantize_params` of a params tree on the meta device (the
    dry-run's serving cells): the stored codes' and scales' shapes and
    dtypes, with no storage."""
    return quantize_params(params_abs, cfg, packed=packed)
