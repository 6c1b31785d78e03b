"""Gradient compression with error feedback: the int8 part of the
reference's `parallel/collectives.py` (the expert-parallel all-to-all and
`compressed_psum` wait for ROADMAP A11).

Each tensor is quantized to int8 with a per-tensor symmetric scale; the
residue the codes cannot represent is carried into the next step's
gradient (error feedback), so the compression bias does not accumulate.
Inside a single-participant train step (the reference's GSPMD step, where
the all-reduce is implicit) `compress_decompress` simulates the wire
format.
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor):
    """x (f32/bf16) → (int8 codes, f32 scale): scale = max(max|x|,
    1e-12) / 127 (a true division), codes = clip(round(x / scale), −127,
    127), round half to even as jnp.round."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) \
        / torch.full((), 127.0, device=xf.device)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(x: torch.Tensor, err: torch.Tensor):
    """Single-participant Q→DQ with error feedback: xf = x + err (f32) →
    (dequantized xf in x's dtype, the new residue xf − dequantized)."""
    xf = x.float() + err
    q, scale = quantize_int8(xf)
    y = dequantize_int8(q, scale)
    return y.to(x.dtype), xf - y
