"""Multi-pod dry-run of the port: prove every (arch × shape × mesh) cell
plans, traces, fits, and report its roofline terms — without the hardware
the plan is for.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --mesh single [--cim bp] [--out experiments/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch qwen2-moe-a2.7b --shape decode_32k --mesh host \\
      --cim bp-prequant --ep a2a --device cpu   # the world's real mesh

torch has no lowering, no compile and no cost analysis; a cell here is
the port's own program, run for rank 0 on the meta device (tensors with
shapes and dtypes and no storage):

* parameters are the port's init on meta (`registry.abstract_params`;
  layer stacks as per-layer lists), quantized on meta for bp-prequant
  (`quantize.abstract_quantized_params`); the batch and the decode cache
  are meta tensors (`registry.input_specs`, `init_cache` on meta);
* single / multi is a planned mesh, (data 16, model 16) or (pod 2, data
  16, model 16) at rank 0 with no process group (`PRODUCTION_MESHES`, a
  `sharding.PlannedMesh`: the reference's production topology); host is
  the world's real mesh (`make_host_smoke_mesh`: one rank in one
  process; `--device` picks its process group's backend, the card's by
  default);
* every argument's placement follows the reference's rules
  (`params_shardings` / `batch_shardings` / `cache_shardings`: the specs
  of `sharding.tree_param_specs` / `spec_for` on the mesh), and its
  per-chip bytes follow from them. A train cell's state (params and
  optimizer state) is placed as the port's Trainer places it: its step
  runs on rank 0's blocks (`sharding.tree_place`, meta tensors of the
  blocks' shapes; `Placed.blocks`), so its planned bytes are what rank 0
  holds. The batch is still whole on every rank in the port (it is not
  split over the batch axes), and serving params are whole on every rank
  (`parallel.sharding`): their bytes are the plan's, the reference's,
  not what the port's ranks hold;
* rank 0's step runs on meta inside `analysis.hlo.count_costs`: FLOPs
  and bytes of every aten op, each CIM MVM by its kernel's own work (not
  run: `core.engine`), the collectives it issues (recorded, not issued,
  under a planned mesh; the state's gathers and the optimizer's sums over
  the shards among them, also counted apart as state traffic) and the
  peak of the live bytes it allocates.

The JSON cell has the reference's keys. memory_analysis holds
argument_size_in_bytes (the planned per-chip bytes of params, optimizer
state, batch and cache; the port's train step takes no PRNG key, so the
reference's 8-byte key is not among them), temp_size_in_bytes (the peak
live bytes rank 0's traced step allocated: the port keeps activations
whole on every rank), output_size_in_bytes (the results it allocated),
alias_size_in_bytes (the results that share an argument's storage: the
cache written in place) and peak_memory_in_bytes (argument + temp); there
is no generated code.

The cell's "program" names what was traced, since on a planned mesh the
argument bytes are the plan's and everything else is rank 0's program:
"one-rank" (a one-chip mesh: the plan and the program are one),
"rank0-whole-tensors" (the step issued no collective: it partitions
nothing and is the whole model's step, FLOPs, bytes and temp of every
layer whole, so the roofline sets it against the whole model_flops,
`work_chips` 1), "rank0-sharded-state" (a train step whose only
collectives move its placed state: each layer's gather, the optimizer's
sums over the shards; they partition no work, every rank still computes
the whole step, so `work_chips` stays 1 and the useful ratio is the
whole-tensor step's; the gathers count in collective_bytes, and apart in
collective_detail["state_bytes"] of the direct trace) or
"rank0-partitioned" (the sharded kernel MVMs, the expert slices or the
KV heads divided over the mesh, the rest whole on every rank;
`work_chips` the mesh's chips). Only collectives
outside the state's decide between the last two.
peak_memory_in_bytes is one chip's memory only where the program is
"one-rank". lower_s is the seconds to build the cell, compile_s the
seconds of the meta trace. The trace runs every layer, so its counts
are exact ("traced(every-layer-counted)"); --analysis extrapolate
recomputes them by the reference's per-layer differencing, which must
give the same numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import NamedTuple

import torch

from repro_torch.analysis import hlo
from repro_torch.analysis.roofline import Roofline, count_params, model_flops
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.configs.registry import ARCHS, cell_is_runnable
from repro_torch.core.cim_matmul import CIMConfig
from repro_torch.core.macro import SimLevel
from repro_torch.models import registry
from repro_torch.parallel import sharding
from repro_torch.runtime.trainer import make_optimizer, make_train_step


# the reference's production topology, planned at rank 0 (no process group)
PRODUCTION_MESHES = {"single": {"data": 16, "model": 16},
                     "multi": {"pod": 2, "data": 16, "model": 16}}


# ---------------------------------------------------------------------------
# placement of abstract inputs
# ---------------------------------------------------------------------------
class Placed(NamedTuple):
    """An argument of the step (a tree of meta tensors) and its specs (the
    same tree, a spec tuple per tensor): the reference's
    ShapeDtypeStructs with their NamedShardings. `blocks`: the tree the
    step runs on where it is not `tree` itself (a train state placed on
    the mesh: rank 0's block of every leaf)."""

    tree: object
    specs: object
    blocks: object = None

    @property
    def traced(self):
        """The tree rank 0's step runs on."""
        return self.tree if self.blocks is None else self.blocks


def _map_path(fn, tree, path=()):
    """fn(path, tensor) over a tree of dicts and lists, the same tree."""
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _zip_leaves(tree, specs):
    """(tensor, spec) pairs of a tree and its spec tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _zip_leaves(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            yield from _zip_leaves(v, s)
    else:
        yield tree, specs


def _spec_of(t, logical) -> tuple:
    return sharding.spec_for(tuple(t.shape), tuple(logical))


def batch_shardings(batch_abs, mesh):
    """Every batch input sharded over the batch axes on its leading dim."""
    del mesh
    return _map_path(lambda _, t: _spec_of(t, ("batch",)
                                            + (None,) * (t.ndim - 1)),
                     batch_abs)


def cache_shardings(cache_abs, mesh):
    """Decode-cache sharding: batch over batch axes when divisible (then the
    sequence axis goes over "model" = SP decode); otherwise the sequence axis
    spreads over (data, model) — the long_500k single-sequence layout."""
    del mesh      # the placement reads the active mesh (sharding.set_mesh)
    baxes = sharding.resolve("batch") or ()
    bsize = math.prod(sharding.axis_size(a) for a in baxes)

    def one(path, t):
        name = str(path[-1])
        nd = t.ndim
        if nd == 0:
            return ()
        if name in ("k", "v", "latent"):
            batch_ok = t.shape[1] % max(bsize, 1) == 0
            seq_log = "seq_tp" if batch_ok else "seq"
            return _spec_of(t, [None, "batch" if batch_ok else None,
                                seq_log] + [None] * (nd - 3))
        if name == "S":
            return _spec_of(t, (None, "batch", "tp") + (None,) * (nd - 3))
        if name == "conv":
            return _spec_of(t, (None, "batch", None, "tp"))
        if name in ("tm_x", "cm_x"):
            return _spec_of(t, (None, "batch") + (None,) * (nd - 2))
        return (None,) * nd

    return _map_path(one, cache_abs)


def params_shardings(params_abs, mesh):
    del mesh
    return sharding.tree_param_specs(params_abs)


def per_chip_bytes(placed: Placed) -> int:
    """Bytes of one chip's shard of every tensor of `placed` on the
    active mesh (each spec's axes divide their dim)."""
    total = 0
    for t, spec in _zip_leaves(placed.tree, placed.specs):
        div = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    div *= sharding.axis_size(a)
        total += t.numel() * t.element_size() // div
    return total


# ---------------------------------------------------------------------------
# per-cell build and trace
# ---------------------------------------------------------------------------
def choose_optimizer(params_abs) -> str:
    return "adafactor" if count_params(params_abs) > 3e10 else "adamw"


# train-step knobs for §Perf variants (e.g. {"microbatch": 8}); the launch
# CLI keeps defaults — only repro_torch.launch.perf mutates this.
TC_OVERRIDES: dict = {}


def build_cell(arch: str, shape_name: str, mesh, *, cim: str = "off",
               cfg_override=None, ep: str | None = None):
    """Returns (step_fn, (Placed, ...) arguments, cfg, params_abs); the
    step runs on the arguments' trees. (The reference's `unroll` has no
    counterpart: the port's trace runs every layer.)"""
    del mesh      # the placement reads the active mesh (sharding.set_mesh)
    cfg = cfg_override or ARCHS[arch]
    if cim == "bp-noisy":
        # NOISY converter chain with a fixed noise_seed: backend "auto"
        # resolves to the stochastic kernels (cuda_noisy[_packed]), which
        # the engine partitions over the mesh
        cfg = cfg.replace(cim=CIMConfig(
            enabled=True, backend="auto", noise_seed=0,
            macro=dataclasses.replace(CIMConfig().macro,
                                      sim_level=SimLevel.NOISY)))
    elif cim != "off":
        cfg = cfg.replace(cim=CIMConfig(enabled=True, backend="scan"))
    if ep and cfg.moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, ep_mode=ep))
    prequant = cim == "bp-prequant"
    shape = SHAPES[shape_name]
    mod = registry.get_module(cfg)
    max_seq = shape.seq_len + (8 if shape.kind != "train" else 0)
    params_abs = registry.abstract_params(cfg, max_seq=max_seq)
    if prequant:  # serving with offline-quantized stored codes
        from repro_torch.models.quantize import abstract_quantized_params
        params_abs = abstract_quantized_params(params_abs, cfg)
    p_sh = params_shardings(params_abs, None)
    batch_abs = registry.input_specs(cfg, shape)
    b_sh = batch_shardings(batch_abs, None)

    if shape.kind == "train":
        tc = TrainConfig(optimizer=choose_optimizer(params_abs),
                         **TC_OVERRIDES)
        state_abs = {"params": params_abs,
                     "opt": make_optimizer(tc).init(params_abs)}
        state_sh = {"params": p_sh,
                    "opt": sharding.tree_param_specs(state_abs["opt"])}
        cut = sharding.any_cut(state_sh)     # the Trainer's placement
        step, _ = make_train_step(cfg, tc, state_sh if cut else None)
        blocks = sharding.tree_place(state_abs, state_sh) if cut else None
        return step, (Placed(state_abs, state_sh, blocks),
                      Placed(batch_abs, b_sh)), cfg, params_abs

    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            return mod.prefill(params, batch, cfg)
        return prefill_fn, (Placed(params_abs, p_sh),
                            Placed(batch_abs, b_sh)), cfg, params_abs

    # decode: one new token against a seq_len-deep cache
    cache_abs = mod.init_cache(cfg, shape.global_batch, shape.seq_len,
                               device="meta")
    c_sh = cache_shardings(cache_abs, sharding.get_mesh())

    def decode_fn(params, tokens, cache):
        return mod.decode_step(params, tokens, cache, cfg)

    return decode_fn, (Placed(params_abs, p_sh),
                       Placed(batch_abs["tokens"], b_sh["tokens"]),
                       Placed(cache_abs, c_sh)), cfg, params_abs


def trace_step(fn, trees, *, train: bool) -> hlo.StepCost:
    """Run `fn(*trees)` once inside the cost counter (gradients on for a
    train step, off otherwise): the dry-run's counterpart of compiling."""
    with hlo.count_costs(trees) as cost, torch.set_grad_enabled(train):
        cost.result = fn(*trees)
    return cost


@dataclasses.dataclass
class MemoryAnalysis:
    """The port's counterpart of compiled.memory_analysis() (module
    docstring)."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int
    peak_memory_in_bytes: int


def _memory(args, cost: hlo.StepCost) -> MemoryAnalysis:
    arg = sum(per_chip_bytes(a) for a in args)
    return MemoryAnalysis(
        argument_size_in_bytes=arg, output_size_in_bytes=cost.output_bytes,
        temp_size_in_bytes=cost.temp_bytes,
        alias_size_in_bytes=cost.alias_bytes,
        peak_memory_in_bytes=arg + cost.temp_bytes)


# ---------------------------------------------------------------------------
# per-layer differencing (the reference's exact-cost extrapolation): on the
# port every layer is traced, so it reproduces the direct count
# ---------------------------------------------------------------------------
def _layer_knobs(cfg):
    """[(apply_fn(cfg, k), base_count, full_count)] per homogeneous stack."""
    if cfg.family in ("dense", "vlm", "moe") and not cfg.encoder_layers:
        if cfg.moe and cfg.moe.first_dense:
            fd = cfg.moe.first_dense

            def set_moe(c, k):  # k routed-expert layers, 1 dense layer
                return c.replace(n_layers=1 + k,
                                 moe=dataclasses.replace(c.moe, first_dense=1))

            def set_dense(c, k):  # k dense layers, 1 moe layer
                return c.replace(n_layers=k + 1,
                                 moe=dataclasses.replace(c.moe, first_dense=k))

            return [(set_moe, 1, cfg.n_layers - fd), (set_dense, 1, fd)]
        return [(lambda c, k: c.replace(n_layers=k), 1, cfg.n_layers)]
    if cfg.family == "audio":  # enc-dec: two stacks
        return [
            (lambda c, k: c.replace(n_layers=k), 1, cfg.n_layers),
            (lambda c, k: c.replace(encoder_layers=k), 1, cfg.encoder_layers),
        ]
    if cfg.family == "ssm":
        return [(lambda c, k: c.replace(n_layers=k), 1, cfg.n_layers)]
    raise ValueError(cfg.family)


def _measure_costs(arch, shape_name, mesh, *, cim, cfg_variant) -> dict:
    fn, args, _, _ = build_cell(arch, shape_name, mesh, cim=cim,
                                cfg_override=cfg_variant)
    cost = trace_step(fn, tuple(a.traced for a in args),
                      train=SHAPES[shape_name].kind == "train")
    coll = cost.collectives
    out = {"flops": cost.flops, "bytes": cost.bytes,
           "coll_total": coll.total_bytes}
    for k, v in coll.bytes_by_kind.items():
        out[f"coll_{k}"] = v
    return out


def extrapolated_costs(arch, shape_name, mesh, *, cim="off",
                       cfg_base=None) -> dict:
    """Per-step costs by per-layer differencing of small builds (exact
    integers: equal to the direct trace's wherever a layer's cost does
    not depend on the depth)."""
    cfg = cfg_base or ARCHS[arch]
    if cim != "off":
        cfg = cfg.replace(cim=CIMConfig(enabled=True, backend="scan"))
    if cfg.family == "hybrid":
        # coupled knobs (mamba depth, weight-shared attn applications):
        # F(L, A) = F0 + L·Fm + A·Fs from three small builds
        mk = lambda n, se: cfg.replace(  # noqa: E731
            n_layers=n, ssm=dataclasses.replace(cfg.ssm, shared_every=se))
        m1 = _measure_costs(arch, shape_name, mesh, cim=cim,
                            cfg_variant=mk(1, 0))
        m2 = _measure_costs(arch, shape_name, mesh, cim=cim,
                            cfg_variant=mk(2, 0))
        ms = _measure_costs(arch, shape_name, mesh, cim=cim,
                            cfg_variant=mk(2, 2))
        apps = cfg.n_layers // cfg.ssm.shared_every
        total = {}
        for k in set(m1) | set(m2) | set(ms):
            fm = m2.get(k, 0) - m1.get(k, 0)
            fs = ms.get(k, 0) - m2.get(k, 0)
            total[k] = max(m1.get(k, 0) + (cfg.n_layers - 1) * fm
                           + apps * fs, 0)
        return total
    knobs = _layer_knobs(cfg)
    base_cfg = cfg
    for apply_fn, b, _ in knobs:
        base_cfg = apply_fn(base_cfg, b)
    base = _measure_costs(arch, shape_name, mesh, cim=cim,
                          cfg_variant=base_cfg)
    total = dict(base)
    for apply_fn, b, full in knobs:
        var_cfg = base_cfg
        for f2, b2, _ in knobs:          # keep other knobs at base
            if f2 is not apply_fn:
                var_cfg = f2(var_cfg, b2)
        var_cfg = apply_fn(var_cfg, b + 1)
        plus = _measure_costs(arch, shape_name, mesh, cim=cim,
                              cfg_variant=var_cfg)
        for k in set(base) | set(plus):
            per_layer = plus.get(k, 0) - base.get(k, 0)
            total[k] = total.get(k, 0) + (full - b) * per_layer
    return {k: max(v, 0) for k, v in total.items()}


def _host_mesh(device=None):
    """The world's real (data, model) mesh (one rank in one process)."""
    from repro_torch.launch.mesh import make_host_smoke_mesh
    mesh, data, model = make_host_smoke_mesh(device=device)
    return mesh, f"host{data}x{model}"


def _chips(mesh) -> int:
    return math.prod(sharding.mesh_axes(mesh).values())


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             cim: str = "off", out_dir: str | None = None,
             analysis: str = "scan", cfg_override=None,
             ep: str | None = None, device=None) -> dict:
    shape = SHAPES[shape_name]
    cfg = ARCHS[arch]
    runnable, why = cell_is_runnable(cfg, shape)
    mesh = None
    if mesh_kind == "host":
        mesh, mesh_name = _host_mesh(device)
    else:
        mesh_name = {"single": "pod16x16", "multi": "pod2x16x16"}[mesh_kind]
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + \
        (f"__cim-{cim}" if cim != "off" else "") + \
        (f"__ep-{ep}" if ep else "") + \
        ("__xp" if analysis == "extrapolate" else "")
    result: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "cim": cim, "cell": cell_id}
    if ep:
        result["ep"] = ep
        if runnable and not cfg.moe:
            runnable, why = False, f"--ep {ep} needs a MoE arch"
    if runnable and cim == "bp-prequant" and shape.kind == "train":
        runnable, why = False, \
            "bp-prequant is a serving flow (stored codes are not trainable)"
    if not runnable:
        result["status"] = "skipped"
        result["reason"] = why
        _dump(result, out_dir, cell_id)
        return result

    if mesh is None:
        mesh = sharding.PlannedMesh(PRODUCTION_MESHES[mesh_kind])
    sharding.set_mesh(mesh)
    try:
        t0 = time.monotonic()
        fn, args, cfg2, params_abs = build_cell(arch, shape_name, mesh,
                                                cim=cim,
                                                cfg_override=cfg_override,
                                                ep=ep)
        t_lower = time.monotonic() - t0
        cost = trace_step(fn, tuple(a.traced for a in args),
                          train=shape.kind == "train")
        t_compile = time.monotonic() - t0 - t_lower
        mem = _memory(args, cost)
        coll = cost.collectives
        flops, bytes_ = float(cost.flops), float(cost.bytes)
        coll_total = float(coll.total_bytes)
        state = cost.state_collectives
        coll_detail = {"bytes": coll.bytes_by_kind,
                       "counts": coll.count_by_kind,
                       "state_bytes": state.total_bytes}
        cost_basis = "traced(every-layer-counted)"
        if analysis == "extrapolate":
            ext = extrapolated_costs(arch, shape_name, mesh, cim=cim,
                                     cfg_base=cfg_override)
            flops, bytes_ = float(ext["flops"]), float(ext["bytes"])
            coll_total = float(ext["coll_total"])
            coll_detail = {"bytes": {k[5:]: v for k, v in ext.items()
                                     if k.startswith("coll_") and
                                     k != "coll_total"}}
            cost_basis = "unrolled-per-layer-extrapolation"
        chips = _chips(mesh)
        program = _program(chips, sum(coll.count_by_kind.values()),
                           sum(state.count_by_kind.values()))
        rl = Roofline(
            arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
            hlo_flops=flops, hlo_bytes=bytes_,
            collective_bytes=coll_total,
            model_flops=model_flops(cfg2, shape, params_abs),
            peak_bytes_per_chip=_peak_bytes(mem),
            collective_detail=coll_detail,
            work_chips=chips if program in ("one-rank", "rank0-partitioned")
            else 1,
        )
        result.update({
            "status": "ok", "cost_basis": cost_basis, "program": program,
            "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
            "memory_analysis": _mem_dict(mem),
            "roofline": rl.to_dict(),
        })
    except Exception as e:  # a failing cell is a bug — record it loudly
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc(limit=25)
    finally:
        sharding.set_mesh(None)
    _dump(result, out_dir, cell_id)
    return result


def _program(chips: int, n_collectives: int, n_state: int) -> str:
    """The cell's "program" (module docstring) from the step's collective
    count and how many of them moved the placed state."""
    if chips == 1:
        return "one-rank"
    if n_collectives > n_state:
        return "rank0-partitioned"
    return "rank0-sharded-state" if n_collectives else "rank0-whole-tensors"


def _peak_bytes(mem: MemoryAnalysis) -> float:
    return float(mem.peak_memory_in_bytes)


def _mem_dict(mem: MemoryAnalysis) -> dict:
    return {k: float(v) for k, v in dataclasses.asdict(mem).items()}


def _dump(result: dict, out_dir: str | None, cell_id: str):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
            json.dump(result, f, indent=1)


def status_line(r: dict) -> str:
    """The one-line report of a cell, as the CLI prints it."""
    status = r["status"]
    extra = ""
    if status == "ok":
        rl = r["roofline"]
        extra = (f" dom={rl['dominant']} frac={rl['roofline_fraction']:.3f}"
                 f" mem/chip={r['memory_analysis'].get('temp_size_in_bytes', 0) / 2**30:.2f}GiB"
                 f" compile={r['compile_s']}s")
    elif status == "error":
        extra = " " + r["error"].splitlines()[0][:120]
    return f"[{status:7s}] {r['cell']}{extra}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both", "host"),
                    default="single",
                    help="single/multi = the production 256/512-chip "
                         "meshes, planned at rank 0; host = the world's "
                         "real data×model mesh (one rank in one process)")
    ap.add_argument("--cim", choices=("off", "bp", "bp-noisy", "bp-prequant"),
                    default="off",
                    help="bp = quantize-on-the-fly BP CIM; bp-noisy = same "
                         "with the NOISY converter chain and noise_seed=0 "
                         "(the stochastic kernels, partitioned over the "
                         "mesh); bp-prequant = serving flow with offline "
                         "nibble-packed u4 stored codes (1/4 the bf16 "
                         "weight bytes)")
    ap.add_argument("--ep", choices=("psum", "a2a"), default=None,
                    help="override MoEConfig.ep_mode for MoE archs: a2a = "
                         "all-to-all token-dispatch expert parallelism")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--analysis", choices=("scan", "extrapolate"),
                    default="scan",
                    help="extrapolate = the costs by per-layer differencing "
                         "of small builds (equal to the direct trace's)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--device", default=None,
                    help="--mesh host's process group: the card's (nccl) "
                         "by default, cpu for gloo")
    args = ap.parse_args()

    cells = []
    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for a in archs:
        for s in shapes:
            for m in meshes:
                cells.append((a, s, m))

    for a, s, m in cells:
        r = run_cell(a, s, m, cim=args.cim, out_dir=args.out,
                     analysis=args.analysis, ep=args.ep, device=args.device)
        print(status_line(r), flush=True)


if __name__ == "__main__":
    main()
