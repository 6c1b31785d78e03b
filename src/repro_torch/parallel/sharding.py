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

Execution model. The port runs eagerly. Activations are whole and
identical on every rank, and so are the parameters a step reads: the
Server's and the model API's params are whole on every rank (every rank
builds the same params from the seed). Only the partitioned computations
run on a rank's block: the CIM MVM (`core.engine`: each rank takes its
shard of x and of the weights by `mvm_plan` and runs its kernel), the MoE
experts (`models.moe`: a rank's experts and tokens) and the paged
attention's KV heads (`kernels.paged_attention`). The partial results are
summed and gathered back into the whole output (`shard`, `ordered_sum`,
`mean_over`, `gather`: autograd functions whose backward is the matching
collective, so gradients are those of the whole tensors; a tensor read
whole by every rank's block sums its gradient over the partitioning
axes). `constrain` is therefore a layout annotation with no effect: the
activations it names are already whole on every rank.

The Trainer's state at rest is the exception (the reference's ZeRO-3):
on a mesh each rank holds only its block of every state leaf (params,
the optimizer's moments or factored statistics, the error-feedback
buffers), cut by the rule tree (`tree_param_specs`; `place` /
`tree_place`, the block the reference's NamedSharding puts on the device
at the same mesh coordinates). The train step reads its params inside
`placed_state`, where the models gather each layer whole when it runs
(`gathered`, built on `unshard`) and drop it after; the gradients come
back as blocks, and the optimizer updates blocks, summing over the
shards in rank order where a rule reduces over a cut dim
(`sum_over_ranks`, `max_over_ranks`). Serving never enters
`placed_state`, so `gathered` is the identity there. The collectives of
the state (its gathers, the optimizer's sums) run inside
`runtime.telemetry.state_traffic`, which the dry-run counts apart: they
move the state and partition no work.

Collectives. Every collective the port issues goes through the helpers
at the end of this module (`all_gather`, `reduce_scatter_tensor`,
`all_to_all_single`, `all_reduce`, and `send_recv` / `broadcast` for the
pipeline), which record (kind, operand bytes) into the active
`runtime.telemetry` recorders for the dry-run's accounting
(`analysis.hlo`). Under a `PlannedMesh` (a
production mesh that is only planned: axis sizes and this rank's
coordinates, no process group) they issue nothing and return tensors of
the right shape, so rank 0's program runs on the meta device as it would
run on the mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.runtime.telemetry import record_collective, state_traffic
from repro_torch.trees import tree_leaves, tree_map

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


class PlannedGroup(NamedTuple):
    """One axis of a PlannedMesh, where a process group would be."""

    axis: str
    size: int


class PlannedMesh:
    """A mesh that is planned, not built: {axis name: size} in mesh order,
    seen from rank 0 (coordinate 0 on every axis), with no process group.
    The sharding rules read it as they read a DeviceMesh; its collectives
    are recorded and issue nothing (module docstring)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    def get_local_rank(self, axis: str) -> int:
        return 0

    def get_group(self, axis: str) -> PlannedGroup:
        return PlannedGroup(axis, self.shape[axis])


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


def axis_size(name: str) -> int:
    """The rank count of mesh axis `name` (1 without a mesh or axis)."""
    return _axis_size(name)


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


def leaf_spec(path: Sequence, shape: Sequence[int]) -> tuple:
    """The spec of one leaf at `path` (its keys, a list index as an int)
    whose whole shape is `shape`, by PARAM_RULES on the active mesh."""
    shape = tuple(shape)
    return spec_for(shape, axes_for(tuple(path), len(shape)))


def tree_param_specs(params, path: tuple = ()):
    """A params tree (dicts, lists; tensors or containers with `.data`) →
    the same tree of specs by PARAM_RULES."""
    if isinstance(params, dict):
        return {k: tree_param_specs(v, path + (k,))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(tree_param_specs(v, path + (i,))
                            for i, v in enumerate(params))
    return leaf_spec(path, getattr(params, "data", params).shape)


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


def spec_slices(spec: Sequence) -> list[tuple[int, tuple]]:
    """A spec → the (dim, mesh axes) of its sharded dims, in dim order
    (the `slices` of `shard`)."""
    return [(d, e if isinstance(e, tuple) else (e,))
            for d, e in enumerate(spec) if e is not None]


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


def axis_index(name: str) -> int:
    """This rank's index on mesh axis `name` (the reference's
    `jax.lax.axis_index`): 0 without a mesh or on an axis of one rank."""
    return shard_index((name,))[0] if _live((name,)) else 0


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
    return all_gather(t, _MESH.get_group(axis))


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


class _MeanOver(torch.autograd.Function):
    """Forward: the mean of `t` over the ranks of `axes` (`_sum_over`, then
    one division by the rank count). Backward: g / n, each rank's share
    (the reference's pmean)."""

    @staticmethod
    def forward(ctx, t, axes):
        ctx.n = math.prod(_axis_size(a) for a in axes)
        return _sum_over(t, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _Gather(torch.autograd.Function):
    """Forward: the shards of a tensor along `dim` over `axes`,
    concatenated in rank order (the last axis innermost). Backward: this
    rank's slice of the whole gradient, a copy (a view would keep the
    whole gradient alive)."""

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
        return g.narrow(ctx.dim, idx * size, size).clone(
            memory_format=torch.contiguous_format), None, None


class _ReduceScatter(torch.autograd.Function):
    """Forward: Σ of the partial `t` over `axis`, this rank's slice of it
    along `dim` (reduce_scatter). Backward: the slices' gradients
    gathered (all_gather): every rank's partial enters every slice."""

    @staticmethod
    def forward(ctx, t, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        group = _MESH.get_group(axis)
        n = group_size(group)
        moved = t.movedim(dim, 0).contiguous()
        out = moved.new_empty((moved.shape[0] // n, *moved.shape[1:]))
        reduce_scatter_tensor(out, moved, group)
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
    part = _live(part_axes)
    if not live and not part:
        return t
    # with no live slice the block is the whole tensor, still read by
    # every rank's shard of the computation: its gradient is summed
    return _Shard.apply(t, live, part)


def ordered_sum(t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Σ of the partial `t` over the ranks of `axes`, in rank order."""
    axes = _live(axes)
    return _OrderedSum.apply(t, axes) if axes else t


def mean_over(t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """The mean of `t` over the ranks of `axes`, summed in rank order (the
    reference's pmean; the identity over one rank)."""
    axes = _live(axes)
    return _MeanOver.apply(t, axes) if axes else t


def gather(t: torch.Tensor, dim: int, axes: Sequence[str], *,
           size: int | None = None) -> torch.Tensor:
    """The whole tensor from its shards along `dim` over `axes`; with
    `size`, its first `size` entries along `dim` (the reference's tiled
    all_gather then [:size], where the shards were padded)."""
    live = _live(axes)
    if live:
        t = _Gather.apply(t, dim % t.ndim, live)
    if size is not None and size != t.shape[dim]:
        t = t.narrow(dim, 0, size)
    return t


# ---------------------------------------------------------------------------
# the Trainer's state at rest: this rank's block of every leaf (module
# docstring), and the whole leaf back from the blocks
# ---------------------------------------------------------------------------
def _cuts(spec: Sequence) -> list[tuple[int, tuple]]:
    """The (dim, live mesh axes) of each dim of `spec` that a live axis
    cuts (`spec_slices` less the axes of one rank)."""
    return [(d, live) for d, axes in spec_slices(spec)
            if (live := _live(axes))]


def spec_axes(spec: Sequence) -> tuple:
    """The live mesh axes that cut any dim of `spec`, in the mesh's order
    (empty for a leaf that is whole on every rank)."""
    used = {a for _, axes in _cuts(spec) for a in axes}
    return tuple(a for a in _axes() if a in used)


def block_bounds(shape: Sequence[int], spec: Sequence) -> tuple:
    """(start, stop) of this rank's block along each dim of a whole tensor
    of `shape` cut by `spec`; along a dim cut over several axes the last
    axis is innermost (`shard_index`: the order `_Gather` concatenates
    in, and the reference's NamedSharding's)."""
    out = [(0, n) for n in shape]
    for d, axes in _cuts(spec):
        idx, k = shard_index(axes)
        size = shape[d] // k
        out[d] = (idx * size, (idx + 1) * size)
    return tuple(out)


def place(t, spec: Sequence):
    """This rank's block of the whole `t` (a tensor, or a numpy array read
    from a checkpoint) by `spec`: a copy, so the whole leaf can be freed;
    `t` itself where no live axis cuts it. Under a PlannedMesh, rank 0's
    block (a meta tensor of the block's shape)."""
    if not _cuts(spec):
        return t
    block = t[tuple(slice(lo, hi) for lo, hi in block_bounds(t.shape, spec))]
    if isinstance(block, torch.Tensor):
        return block.clone(memory_format=torch.contiguous_format)
    return block.copy()


def tree_place(tree, specs):
    """`place` over a state tree and its spec tree."""
    return tree_map(place, tree, specs)


def any_cut(specs) -> bool:
    """Whether any spec of a spec tree has a live axis (a tree on no mesh
    or on a 1-rank mesh has none: placing it changes nothing)."""
    return any(spec_axes(s) for s in tree_leaves(specs))


def unshard(t: torch.Tensor, spec: Sequence) -> torch.Tensor:
    """The whole leaf from this rank's block `t` cut by `spec`: `_Gather`
    along each cut dim (recorded as state traffic). Its backward is this
    rank's slice of the whole gradient, which is right while the
    activations, and so the whole gradients, are identical on every rank;
    once the batch is split over "data" it becomes a reduce-scatter."""
    cuts = _cuts(spec)
    if not cuts:
        return t
    with state_traffic():
        for dim, axes in reversed(cuts):
            t = _Gather.apply(t, dim, axes)
    return t


def unshard_tree(tree, specs):
    """`unshard` over a tree of blocks and its spec tree."""
    return tree_map(unshard, tree, specs)


# the leaves of the state a train step reads (`placed_state`): one table
# {id(block): (block, spec)} per open context
_PLACED: list[dict] = []


@contextlib.contextmanager
def placed_state(tree, specs):
    """While the block runs (a train step's loss and its backward, where
    a recomputed layer gathers again), `gathered` reads the leaves of
    `tree`, this rank's blocks cut by `specs`, whole. specs None: the
    state is whole and nothing is gathered."""
    table = {}
    if specs is not None:
        def note(t, spec):
            if spec_axes(spec):
                table[id(t)] = (t, spec)
        tree_map(note, tree, specs)
    _PLACED.append(table)
    try:
        yield
    finally:
        _PLACED.pop()


def gathered(tree):
    """`tree` (a leaf, or dicts and lists of leaves) with every placed
    block of the open `placed_state` gathered whole (`unshard`): a
    model's layer at its use. The identity outside a placed_state, and
    for leaves that are whole."""
    if not _PLACED or not _PLACED[-1]:
        return tree
    table = _PLACED[-1]

    def one(node):
        if isinstance(node, dict):
            return {k: one(v) for k, v in node.items()}
        if isinstance(node, list):
            return [one(v) for v in node]
        hit = table.get(id(node))
        return unshard(node, hit[1]) if hit is not None \
            and hit[0] is node else node

    return one(tree)


def sum_over_ranks(t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Σ of `t` over the ranks of `axes`, in ascending rank order on each
    axis (`_sum_over`; state traffic, no autograd): the same bits on every
    rank."""
    axes = _live(axes)
    if not axes:
        return t
    with state_traffic():
        return _sum_over(t, axes)


def max_over_ranks(t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """The max of `t` over the ranks of `axes` (a MAX all-reduce per axis,
    exact; state traffic, no autograd)."""
    axes = _live(axes)
    if not axes:
        return t
    t = t.clone()
    with state_traffic():
        for a in axes:
            all_reduce(t, _MESH.get_group(a), op=dist.ReduceOp.MAX)
    return t


# ---------------------------------------------------------------------------
# the collectives: recorded (runtime.telemetry), issued unless the group
# is planned
# ---------------------------------------------------------------------------
def group_size(group) -> int:
    """The rank count of a process group or of a PlannedGroup."""
    if isinstance(group, PlannedGroup):
        return group.size
    return dist.get_world_size(group)


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's `t` over `group`, in rank order (under a planned group
    this rank's `t`, then uninitialised stand-ins for the others)."""
    record_collective("all-gather", t)
    n = group_size(group)
    if isinstance(group, PlannedGroup):
        return [t] + [torch.empty_like(t) for _ in range(n - 1)]
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def reduce_scatter_tensor(out: torch.Tensor, inp: torch.Tensor,
                          group) -> None:
    """dist.reduce_scatter_tensor (sum) into `out`."""
    record_collective("reduce-scatter", inp)
    if not isinstance(group, PlannedGroup):
        dist.reduce_scatter_tensor(out, inp, group=group)


def all_to_all_single(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """dist.all_to_all_single into `out`."""
    record_collective("all-to-all", inp)
    if not isinstance(group, PlannedGroup):
        dist.all_to_all_single(out, inp, group=group)


def all_reduce(t: torch.Tensor, group, op=None) -> None:
    """dist.all_reduce of `t` in place (sum unless `op`)."""
    record_collective("all-reduce", t)
    if not isinstance(group, PlannedGroup):
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=group)


def send_recv(send: torch.Tensor | None, dst: int | None,
              recv: torch.Tensor | None, src: int | None, group) -> None:
    """One hop of a permute over `group`: `send` to the group's rank
    `dst` and `recv` (filled in place) from its rank `src`, either side
    None, issued together (dist.batch_isend_irecv). Recorded as one
    collective-permute of the hop's tensor, as the reference's ppermute
    is on every rank."""
    record_collective("collective-permute",
                      send if send is not None else recv)
    if isinstance(group, PlannedGroup):
        return
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(),
                              dist.get_global_rank(group, dst), group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, src), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def broadcast(t: torch.Tensor, src: int, group) -> None:
    """dist.broadcast of `t` in place from the group's rank `src`
    (recorded as the reference's ppermute of it: collective-permute)."""
    record_collective("collective-permute", t)
    if not isinstance(group, PlannedGroup):
        dist.broadcast(t, dist.get_global_rank(group, src), group=group)
