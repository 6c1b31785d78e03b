"""The reference's `parallel/collectives.py` on torch.distributed:
gradient compression with error feedback (`compressed_psum` on a process
group) and the expert-parallel all-to-all token exchange
(`a2a_dispatch` / `a2a_combine`, used by models.moe's a2a-EP path).

a2a_dispatch / a2a_combine are the static-capacity expert-parallel token
exchange: every source rank packs its routed tokens into per-expert
capacity slots, and the pair of all-to-alls over the mesh axis moves only
those slots. Each is an autograd function whose backward is the other
one, and the identity on an axis of one rank (no collective is issued).

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
from repro_torch.parallel import sharding


def dispatch_exchange(send: torch.Tensor, group) -> torch.Tensor:
    """a2a_dispatch's all-to-all over `group` (no autograd, no skip on one
    rank): send [E_pad, cap, D] → [E_pad / ep, ep·cap, D]."""
    ep = sharding.group_size(group)
    e_pad, cap = send.shape[:2]
    recv = torch.empty_like(send.contiguous())
    sharding.all_to_all_single(recv, send.contiguous(), group)
    # recv holds source s's [E_local, cap, D] block at [s]
    return recv.reshape(ep, e_pad // ep, cap, *send.shape[2:]) \
        .transpose(0, 1).reshape(e_pad // ep, ep * cap, *send.shape[2:])


def combine_exchange(out: torch.Tensor, group) -> torch.Tensor:
    """a2a_combine's all-to-all over `group` (no autograd, no skip on one
    rank): out [E_local, ep·cap, D] → [ep·E_local, cap, D]."""
    ep = sharding.group_size(group)
    e_local, rows = out.shape[:2]
    cap = rows // ep
    send = out.reshape(e_local, ep, cap, *out.shape[2:]).transpose(0, 1) \
        .contiguous()
    back = torch.empty_like(send)
    sharding.all_to_all_single(back, send, group)
    return back.reshape(ep * e_local, cap, *out.shape[2:])


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, send, axis):
        ctx.axis = axis
        return dispatch_exchange(send, sharding.get_mesh().get_group(axis))

    @staticmethod
    def backward(ctx, g):
        return combine_exchange(
            g, sharding.get_mesh().get_group(ctx.axis)), None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, axis):
        ctx.axis = axis
        return combine_exchange(out, sharding.get_mesh().get_group(axis))

    @staticmethod
    def backward(ctx, g):
        return dispatch_exchange(
            g, sharding.get_mesh().get_group(ctx.axis)), None


def a2a_dispatch(send: torch.Tensor, axis: str) -> torch.Tensor:
    """EP dispatch: route capacity-slotted tokens to their expert's rank
    over mesh axis `axis` of the active mesh.

    send [E_pad, cap, D] per source rank (slot (e, c) = the c-th token
    this source routed to global expert e). Returns [E_local, ep·cap, D]
    per expert rank: its E_local experts' slots from every source,
    source-major along the capacity axis — recv[e, s·cap + c] is source
    s's slot (rank·E_local + e, c). The backward is a2a_combine's
    exchange; over one rank, the identity."""
    if not sharding._live((axis,)):
        return send
    return _Dispatch.apply(send, axis)


def a2a_combine(out: torch.Tensor, axis: str) -> torch.Tensor:
    """Inverse exchange of a2a_dispatch for the expert outputs: out
    [E_local, ep·cap, D] per expert rank → [E_pad, cap, D] per source
    rank, every token back in the slot its source packed it into. The
    backward is a2a_dispatch's exchange; over one rank, the identity."""
    if not sharding._live((axis,)):
        return out
    return _Combine.apply(out, axis)


def quantize_int8(x: torch.Tensor, axes: tuple = ()):
    """x (f32/bf16) → (int8 codes, f32 scale): scale = max(max|x|,
    1e-12) / 127 (a true division), codes = clip(round(x / scale), −127,
    127), round half to even as jnp.round. With `axes`, x is a rank's
    block of a placed leaf cut over those mesh axes: max|x| is the max
    over the blocks (exact), so the codes are the whole leaf's."""
    xf = x.float()
    amax = sharding.max_over_ranks(torch.max(torch.abs(xf)), axes)
    scale = torch.clamp(amax, min=1e-12) \
        / torch.full((), 127.0, device=xf.device)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(x: torch.Tensor, err: torch.Tensor,
                        axes: tuple = ()):
    """Single-participant Q→DQ with error feedback: xf = x + err (f32) →
    (dequantized xf in x's dtype, the new residue xf − dequantized); with
    `axes`, on a rank's block of a leaf cut over them (`quantize_int8`)."""
    xf = x.float() + err
    q, scale = quantize_int8(xf, axes)
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
    sharding.all_reduce(amax, group, op=dist.ReduceOp.MAX)
    scale = torch.clamp(amax / torch.full((), 127.0, device=xf.device),
                        min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    new_err = fma_f32(-q.float(), scale, xf)
    total = q.to(torch.int32)
    sharding.all_reduce(total, group)
    n = float(sharding.group_size(group))
    return total.float() * scale / n, new_err
