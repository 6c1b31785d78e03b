"""Logical-axis sharding rules, the active mesh and the placement helpers
of the sharded CIM MVM, on torch.distributed.

Logical axis vocabulary (the reference's, mapped onto the mesh axes of
`launch.mesh`):

  "batch" → ("pod", "data") / ("data",)   data parallelism
  "fsdp"  → ("data",)                     parameter sharding (unless
                                          set_fsdp(False))
  "tp"    → ("model",)                    tensor parallelism
  "expert"→ ("model",)                    expert parallelism
  "seq"   → ("data", "model")             sequence parallelism
  "seq_tp"→ ("model",)
  None    → replicated

A spec is a tuple with one entry per dim: None, one mesh axis name, or a
tuple of names. Every helper drops an axis that does not divide its dim
(the reference's silent Megatron fallback).

The active mesh is process-wide (`set_mesh`): a
`torch.distributed.device_mesh.DeviceMesh` with axis names, or, for the
pure rules, any object with `axis_names` and a `shape` dict (the
reference tests' stand-in). Without a mesh every helper is the identity.

Execution model. The port runs eagerly and keeps every model tensor whole
and identical on every rank (every rank builds the same params from the
seed). Only the CIM MVM is partitioned (`core.engine`): each rank takes
its shard of x and of the weights by `mvm_plan`, runs its kernel, and the
partial results are summed and gathered back into the whole output
(`shard`, `ordered_sum`, `gather`: autograd functions whose backward is
the matching collective, so gradients are those of the whole tensors).
`constrain` is therefore a layout annotation with no effect: the
activations it names are already whole on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

_MESH = None
# (the mesh, its {axis name: size}): read once per mesh, not per MVM
_SIZES: tuple = (None, {})
_FSDP: bool = True

# Depth of per-shard regions currently running: the sharded MVM (and any
# caller that already runs per shard) brackets its shard's work, so an
# MVM inside runs on its local operands and is not partitioned again.
_SHARD_DEPTH: list[int] = [0]


def in_shard_context() -> bool:
    """True while per-shard code runs (inside `shard_context`)."""
    return _SHARD_DEPTH[0] > 0


@contextlib.contextmanager
def shard_context():
    """Mark the enclosed code as running per shard."""
    _SHARD_DEPTH[0] += 1
    try:
        yield
    finally:
        _SHARD_DEPTH[0] -= 1


def set_mesh(mesh) -> None:
    """Make `mesh` (or None) the active mesh; its axis sizes are read once
    here, not per MVM."""
    global _MESH
    _MESH = mesh
    _axes()


def set_fsdp(enabled: bool) -> None:
    """Serving topology: inference has no optimizer state, so parameters
    may shard over "model" only and replicate over "data"."""
    global _FSDP
    _FSDP = enabled


def get_mesh():
    return _MESH


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of a stand-in with
    `axis_names` and a `shape` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _axes() -> dict[str, int]:
    """{axis name: size} of the active mesh ({} without one), cached
    until the active mesh changes."""
    global _SIZES
    if _SIZES[0] is not _MESH:
        _SIZES = (_MESH, {} if _MESH is None else mesh_axes(_MESH))
    return _SIZES[1]


def _axis_size(name: str) -> int:
    return _axes().get(name, 1)


def resolve(logical: Optional[str]) -> Optional[tuple[str, ...]]:
    """Logical axis name → tuple of mesh axes (or None = replicated)."""
    if logical is None or _MESH is None:
        return None
    names = _axes()
    table = {
        "batch": tuple(a for a in ("pod", "data") if a in names),
        "fsdp": ("data",) if ("data" in names and _FSDP) else (),
        "tp": ("model",) if "model" in names else (),
        "expert": ("model",) if "model" in names else (),
        "seq": tuple(a for a in ("data", "model") if a in names),
        "seq_tp": ("model",) if "model" in names else (),
    }
    axes = table.get(logical, ())
    return axes or None


def _ent(axes: tuple):
    return None if not axes else (axes if len(axes) > 1 else axes[0])


def spec_for(shape: Sequence[int],
             logical: Sequence[Optional[str]]) -> tuple:
    """One spec entry per dim, dropping axes that do not divide the dim."""
    assert len(shape) == len(logical), (shape, logical)
    entries = []
    for dim, name in zip(shape, logical):
        axes = resolve(name)
        total = math.prod(_axis_size(a) for a in axes) if axes else 1
        entries.append(_ent(axes) if total > 1 and dim % total == 0
                       else None)
    return tuple(entries)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The reference's sharding constraint by logical names: the identity
    here, with or without a mesh (activations stay whole on every rank;
    see the module docstring)."""
    return x


# ---------------------------------------------------------------------------
# Parameter rules: leaf-name → logical axes (innermost dims; a leading
# stacked "layers" dim is prepended with None by axes_for).
# ---------------------------------------------------------------------------
PARAM_RULES: dict[str, tuple] = {
    # embeddings / heads
    "embed": ("tp", "fsdp"), "head": ("fsdp", "tp"),
    "pos_embed": (None, "fsdp"),
    # attention
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("fsdp", "tp"),
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",), "bo": (None,),
    # mlp: the down projection keeps N over "tp" like the up projections,
    # as the CIM MVM shards every weight (K over "data", N over "model")
    "w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"), "w_down": ("fsdp", "tp"),
    # norms / scalars
    "scale": (None,), "bias": (None,), "w_lambda": (None,),
    # MLA
    "w_dq": ("fsdp", "tp"), "w_uq": ("fsdp", "tp"),
    "w_dkv": ("fsdp", None), "w_uk": ("fsdp", "tp"), "w_uv": ("fsdp", "tp"),
    "w_kr": ("fsdp", None), "w_proj": ("fsdp", "tp"),
    # MoE (leading E dim = expert parallel; D dim FSDP)
    "router": ("fsdp", None),
    "e_gate": ("expert", "fsdp", None), "e_up": ("expert", "fsdp", None),
    "e_down": ("expert", None, "fsdp"),
    # SSM / RWKV
    "w_in": ("fsdp", "tp"), "w_out": ("fsdp", "tp"),
    "w_x": ("fsdp", "tp"), "conv_w": (None, "tp"), "conv_b": ("tp",),
    "a_log": ("tp",), "dt_bias": ("tp",), "d_skip": ("tp",),
    "w_r": ("fsdp", "tp"), "w_k": ("fsdp", "tp"), "w_v": ("fsdp", "tp"),
    "w_g": ("fsdp", "tp"),
    "decay_w0": ("tp",), "decay_a": ("fsdp", None), "decay_b": (None, "tp"),
    "bonus_u": ("tp",), "mu": (None, None),
    "w_dt": ("fsdp", "tp"), "w_bc": ("fsdp", None),
    "norm_g": ("tp",),
}


def _stacked(path: tuple) -> bool:
    """A leaf under a stacked-layers subtree carries a leading L dim: a
    key containing "layers" above it, not followed by a list index (the
    port keeps its layers as a list of per-layer trees)."""
    return any(isinstance(p, str) and "layers" in p
               and not (i + 1 < len(path) and isinstance(path[i + 1], int))
               for i, p in enumerate(path[:-1]))


def axes_for(path: tuple, ndim: int) -> tuple:
    """Logical axes for a param at `path` (its keys), arity-adjusted: the
    reference's rules, including the stacked-layers prefix, Adafactor's
    factored <param>/vr (drop the last dim) and <param>/vc (drop the
    second-to-last), the unfactored <param>/v, offline-quantized `_q`
    codes (sharded like the weight) and replicated `_scale`s."""
    name = path[-1]
    if name in ("vr", "vc") and len(path) >= 2:
        base = PARAM_RULES.get(path[-2])
        if base is not None:
            rules = base[:-1] if name == "vr" else base[:-2] + base[-1:]
            if _stacked(path[:-1]):
                rules = (None,) + tuple(rules)
            if len(rules) < ndim:
                rules = (None,) * (ndim - len(rules)) + tuple(rules)
            return tuple(rules[:ndim])
    if name == "v" and len(path) >= 2 and path[-2] in PARAM_RULES:
        name = path[-2]
    if isinstance(name, str) and name.endswith("_q"):
        name = name[:-2]
    elif isinstance(name, str) and name.endswith("_scale"):
        return (None,) * ndim
    rules = PARAM_RULES.get(name)
    if rules is None:
        rules = (None,) * ndim
    if _stacked(path):
        rules = (None,) + tuple(rules)
    if len(rules) < ndim:
        rules = (None,) * (ndim - len(rules)) + tuple(rules)
    return tuple(rules[:ndim])


def tree_param_specs(params, path: tuple = ()):
    """A params tree (dicts, lists; tensors or containers with `.data`) →
    the same tree of specs by PARAM_RULES."""
    if isinstance(params, dict):
        return {k: tree_param_specs(v, path + (k,))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(tree_param_specs(v, path + (i,))
                            for i, v in enumerate(params))
    shape = tuple(getattr(params, "data", params).shape)
    return spec_for(shape, axes_for(path, len(shape)))


# ---------------------------------------------------------------------------
# The partition plan of one sharded MVM (core.engine's mesh dispatch).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MVMPlan:
    """How one x[..., K] @ w[K, M] MVM maps onto the active mesh.

    ctr_axes shard the contraction (K): each shard evaluates its own
    macro groups, and the partial MVMs are summed after each shard's ADC
    transfer and Eq. 7 correction. row_axes shard the leading activation
    dim, col_axes the output channels (M); empty tuples mean replicated.
    """

    ctr_axes: tuple = ()
    row_axes: tuple = ()
    col_axes: tuple = ()

    def x_spec(self, ndim: int) -> tuple:
        lead = [None] * (ndim - 1)
        if self.row_axes and ndim > 1:
            lead[0] = _ent(self.row_axes)
        return (*lead, _ent(self.ctr_axes))

    def w_spec(self) -> tuple:
        return (_ent(self.ctr_axes), _ent(self.col_axes))

    def out_spec(self, ndim: int) -> tuple:
        lead = [None] * (ndim - 1)
        if self.row_axes and ndim > 1:
            lead[0] = _ent(self.row_axes)
        return (*lead, _ent(self.col_axes))

    @property
    def axes(self) -> tuple:
        """The mesh axes that partition this MVM, in the mesh's order."""
        used = self.ctr_axes + self.row_axes + self.col_axes
        return tuple(a for a in _axes() if a in used)


def mvm_plan(x_shape: Sequence[int], k: int, m: int, *,
             k_unit: int = 1) -> MVMPlan:
    """Partition plan for one MVM on the active mesh (identity without).

    The contraction goes over "data" when K divides (in units of `k_unit`
    rows: 2 for nibble-packed weights, so no byte is split); the output
    channels over "model" when M divides; the leading activation dim over
    "pod" (and over "data" too when the contraction left it free).
    """
    if _MESH is None:
        return MVMPlan()
    axes = _axes()
    ctr: tuple = ()
    if "data" in axes:
        size = axes["data"]
        if size > 1 and k % (size * k_unit) == 0:
            ctr = ("data",)
    col: tuple = ()
    if "model" in axes and m % axes["model"] == 0:
        col = ("model",)
    row: tuple = ()
    if len(x_shape) > 1:
        lead = x_shape[0]
        for ax in ("pod",) + (("data",) if not ctr else ()):
            if ax in axes and lead % (axes[ax] * math.prod(
                    axes[a] for a in row)) == 0:
                row = row + (ax,)
    return MVMPlan(ctr_axes=ctr, row_axes=row, col_axes=col)


# ---------------------------------------------------------------------------
# placement on the active DeviceMesh: this rank's shard of a whole tensor,
# and the whole tensor back from the shards
# ---------------------------------------------------------------------------
def _live(axes: Sequence[str]) -> tuple:
    """The axes of `axes` with more than one rank: a collective over one
    rank is the identity, so the placement helpers skip the others (a
    1-rank mesh runs no collective at all)."""
    return tuple(a for a in axes if _axis_size(a) > 1)


def shard_index(axes: Sequence[str]) -> tuple[int, int]:
    """(this rank's linear index, the shard count) over `axes`, the first
    axis major."""
    sizes = _axes()
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes[a] + _MESH.get_local_rank(a)
        n *= sizes[a]
    return idx, n


def _all_gather(t: torch.Tensor, axis: str) -> list[torch.Tensor]:
    group = _MESH.get_group(axis)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def _sum_over(t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Σ over the ranks of `axes`, added in ascending rank order on each
    axis ((p0 + p1) + p2 ...; all_gather, then the sum), so every rank
    gets the same bits whatever the collective's own order."""
    for a in axes:
        parts = _all_gather(t, a)
        t = parts[0]
        for p in parts[1:]:
            t = t + p
    return t


class _Shard(torch.autograd.Function):
    """Forward: this rank's block of a whole tensor, narrowed along each
    (dim, axes) of `slices` to this rank's slice over those axes.
    Backward: the block's gradient in place in a zero tensor of the whole
    shape, summed once over `part_axes` (every axis partitioning the
    computation: the whole tensor's gradient is the sum of every rank's
    block's). One op for every dim: a shard of a shard would sum twice,
    and add the gradients of different blocks into one."""

    @staticmethod
    def forward(ctx, t, slices, part_axes):
        ctx.full, ctx.part_axes, ctx.windows = t.shape, part_axes, []
        for dim, axes in slices:
            idx, n = shard_index(axes)
            size = t.shape[dim] // n
            ctx.windows.append((dim, idx * size, size))
            t = t.narrow(dim, idx * size, size)
        return t

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.full)
        block = full
        for dim, start, size in ctx.windows:
            block = block.narrow(dim, start, size)
        block.copy_(g)
        return _sum_over(full, ctx.part_axes), None, None


class _OrderedSum(torch.autograd.Function):
    """Forward: the shards' partial sums over `axes` (`_sum_over`), the
    same whole tensor on every rank. Backward: the identity (each partial
    enters the sum once)."""

    @staticmethod
    def forward(ctx, t, axes):
        return _sum_over(t, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Forward: the shards of a tensor along `dim` over `axes`,
    concatenated in rank order (the last axis innermost). Backward: this
    rank's slice of the whole gradient."""

    @staticmethod
    def forward(ctx, t, dim, axes):
        ctx.dim, ctx.axes = dim, axes
        for a in reversed(axes):
            t = torch.cat(_all_gather(t, a), dim=dim)
        return t

    @staticmethod
    def backward(ctx, g):
        idx, n = shard_index(ctx.axes)
        size = g.shape[ctx.dim] // n
        return g.narrow(ctx.dim, idx * size, size), None, None


class _ReduceScatter(torch.autograd.Function):
    """Forward: Σ of the partial `t` over `axis`, this rank's slice of it
    along `dim` (reduce_scatter). Backward: the slices' gradients
    gathered (all_gather): every rank's partial enters every slice."""

    @staticmethod
    def forward(ctx, t, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        group = _MESH.get_group(axis)
        n = dist.get_world_size(group)
        moved = t.movedim(dim, 0).contiguous()
        out = moved.new_empty((moved.shape[0] // n, *moved.shape[1:]))
        dist.reduce_scatter_tensor(out, moved, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_all_gather(g, ctx.axis), dim=ctx.dim), None, None


def reduce_scatter(t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """Σ of the partial `t` over the ranks of mesh axis `axis`, scattered
    along `dim` (this rank's slice; the order of the sum is the
    collective's)."""
    if not _live((axis,)):
        return t
    return _ReduceScatter.apply(t, dim % t.ndim, axis)


def shard(t: torch.Tensor, slices: Sequence[tuple[int, Sequence[str]]],
          part_axes: Sequence[str]) -> torch.Tensor:
    """This rank's block of the whole tensor `t`: along each (dim, axes)
    of `slices`, its slice over `axes` (the identity over one rank); the
    block's gradient is summed over `part_axes`."""
    live = tuple((dim % t.ndim, _live(axes)) for dim, axes in slices)
    live = tuple((dim, axes) for dim, axes in live if axes)
    if not live:
        return t
    return _Shard.apply(t, live, _live(part_axes))


def ordered_sum(t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Σ of the partial `t` over the ranks of `axes`, in rank order."""
    axes = _live(axes)
    return _OrderedSum.apply(t, axes) if axes else t


def gather(t: torch.Tensor, dim: int, axes: Sequence[str]) -> torch.Tensor:
    """The whole tensor from its shards along `dim` over `axes`."""
    axes = _live(axes)
    if not axes:
        return t
    return _Gather.apply(t, dim % t.ndim, axes)
