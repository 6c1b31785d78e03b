"""Gradient compression with error feedback: the int8 part of the
reference's `parallel/collectives.py`, and `compressed_psum` on a
torch.distributed process group (the expert-parallel all-to-all waits for
its only users, the MoE expert-parallel paths, ROADMAP A11b).

Each tensor is quantized to int8 with a per-tensor symmetric scale; the
residue the codes cannot represent is carried into the next step's
gradient (error feedback), so the compression bias does not accumulate.
Inside a single-participant train step (the reference's GSPMD step, where
the all-reduce is implicit) `compress_decompress` simulates the wire
format.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.adc import fma_f32


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


def compressed_psum(x: torch.Tensor, group, err: torch.Tensor):
    """Mean of x over the ranks of `group` through an int8 wire, with error
    feedback: (the mean-reduced f32 result, the new residue).

    The ranks first agree on one scale (a MAX all-reduce of max|x + err|,
    then / 127, at least 1e-12), so the int32 sum of the int8 codes is
    exact; the only loss is each rank's quantization, which the residue
    carries into the next call. The result is total · scale / n; the
    residue xf − q · scale is rounded once, as the fused multiply-add XLA
    makes of it in the reference's shard_map body."""
    xf = x.float() + err
    amax = torch.max(torch.abs(xf))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax / torch.full((), 127.0, device=xf.device),
                        min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    new_err = fma_f32(-q.float(), scale, xf)
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    n = float(dist.get_world_size(group))
    return total.float() * scale / n, new_err
