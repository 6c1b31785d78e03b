"""The port's counterpart of the reference's compiled-artifact analysis:
collective accounting and the per-step cost counter of the dry-run.

torch has no lowering, no HLO text and no `cost_analysis()`. The dry-run
(`launch.dryrun`) instead runs rank 0's step eagerly on the meta device
(tensors with shapes and no storage) and records what the program does:

* Collectives. The reference parses the partitioned HLO and sums the
  operand bytes of every all-gather / all-reduce / reduce-scatter /
  all-to-all / collective-permute. The port records its actual collective
  calls instead: every one goes through `parallel.sharding`'s helpers
  (all-gather, reduce-scatter, all-to-all, all-reduce, and the
  pipeline's point-to-point hops and final broadcast as
  collective-permute), which add (kind, operand bytes) under the
  reference's kind names to every active recorder
  (`runtime.telemetry.recording`, read here). Under a planned mesh
  (`parallel.sharding.PlannedMesh`, no process group) the call is
  recorded and returns a tensor of the right shape; on a real DeviceMesh
  it is recorded and then made, so one recorder reads a real multi-rank
  run the same way.
* MVMs. `core.engine` counts each CIM MVM on meta operands by its
  kernel's own work (2·M·K·N operations; the x codes, the stored codes
  and the f32 output in bytes) into the same recorders and runs nothing
  for it.
* Every other aten op, through `count_costs`: FLOPs by
  torch.utils.flop_counter.FlopCounterMode's formulas (its
  `flop_registry`, applied in the same dispatch mode), bytes as the operand and
  result bytes of each op (each distinct tensor once; views, which move
  nothing, and bare allocations are not counted), and the peak of the
  live bytes that the step allocated (storages made inside the trace,
  freed when their last tensor dies; the arguments' storages are not
  counted, and an in-place write into one is not an allocation). Only
  ops on the arguments' device count: an op whose inputs all lie on the
  host (a constant rounded to a dtype, a cached seed moved once to the
  device) is host arithmetic, not the step's work.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict

from repro_torch.runtime.telemetry import (  # noqa: F401
    COLLECTIVES, Recorder, recording)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def collective_bytes(records) -> CollectiveStats:
    """(kind, operand bytes) records → bytes and counts by kind."""
    bytes_by: dict[str, int] = defaultdict(int)
    count_by: dict[str, int] = defaultdict(int)
    for kind, nbytes in records:
        bytes_by[kind] += nbytes
        count_by[kind] += 1
    return CollectiveStats(dict(bytes_by), dict(count_by))


@dataclasses.dataclass
class StepCost:
    """A traced step's counts (exact integers): flops and bytes include
    the MVMs' kernel work; temp_bytes is the peak of the live bytes the
    step allocated; output_bytes / alias_bytes are the bytes of the
    step's results that it allocated / that share an argument's storage
    (an in-place cache write, a state the step updates in place)."""

    flops: int = 0
    bytes: int = 0
    temp_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    mvms: int = 0
    recorder: Recorder | None = None
    result: object = None      # the step's return value (set by the caller)

    @property
    def collectives(self) -> CollectiveStats:
        return collective_bytes(self.recorder.collectives)

    @property
    def state_collectives(self) -> CollectiveStats:
        """The collectives that moved the Trainer's placed state (a
        subset of `collectives`: they partition no work)."""
        return collective_bytes(self.recorder.state_collectives)


def tensors(tree):
    """Every tensor in a tree of dicts, lists and tuples (and the `.data`
    of containers that carry one): a step's arguments and results, an
    op's args."""
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)
    elif isinstance(getattr(tree, "data", None), torch.Tensor):
        yield tree.data


def _storage_key(t) -> int:
    return t.untyped_storage()._cdata


def _make_cost_mode():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    aten = torch.ops.aten
    no_bytes = {aten.empty.memory_format, aten.empty_strided.default,
                aten.empty_like.default, aten.detach.default,
                aten.lift_fresh.default}

    class CostMode(TorchDispatchMode):
        """FLOPs (FlopCounterMode's formulas), the operand and result bytes
        of each op, and the live bytes of the storages the traced code
        allocates, with their peak."""

        def __init__(self, arg_keys, device):
            super().__init__()
            self.device = device
            self.flops = 0
            self.bytes = 0
            self.arg_keys = arg_keys
            self.live: dict[int, int] = {}
            self.cur = 0
            self.peak = 0

        def _free(self, key):
            self.cur -= self.live.pop(key, 0)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            outs = list(tensors(out))
            ins = list(tensors((args, kwargs)))
            on_dev = [t for t in (ins or outs) if t.device == self.device]
            if not on_dev:      # host arithmetic (a constant, a seed)
                return out
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += int(count(*args, **kwargs, out_val=out))
            if func not in no_bytes and not func.is_view:
                seen = {id(t): t for t in ins + outs}
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in seen.values())
            for t in outs:
                st = t.untyped_storage()
                key = st._cdata
                if key in self.live or key in self.arg_keys:
                    continue
                self.live[key] = st.nbytes()
                self.cur += self.live[key]
                weakref.finalize(st, self._free, key)
            if self.cur > self.peak:
                self.peak = self.cur
            return out

    return CostMode


@contextlib.contextmanager
def count_costs(args):
    """Count the costs of the code run inside the block, whose arguments
    (trees of tensors: params, state, batch, cache) are `args`; yields a
    StepCost that is filled in when the block ends. Set `.result` on it
    inside the block (the step's return value) for the output and alias
    bytes. Runs on any device; the dry-run runs it on meta."""
    arg_ts = list(tensors(args))
    arg_keys = {_storage_key(t) for t in arg_ts}
    cost = StepCost()
    mode = _make_cost_mode()(arg_keys, arg_ts[0].device)
    with recording() as rec, mode:
        yield cost
    cost.recorder = rec
    cost.mvms = rec.mvms
    cost.flops = mode.flops + rec.mvm_flops
    cost.bytes = mode.bytes + rec.mvm_bytes
    cost.temp_bytes = mode.peak
    out_keys: dict[int, int] = {}
    for t in tensors(cost.result):
        out_keys[_storage_key(t)] = t.untyped_storage().nbytes()
    cost.output_bytes = sum(n for k, n in out_keys.items()
                            if k not in arg_keys)
    cost.alias_bytes = sum(n for k, n in out_keys.items() if k in arg_keys)
