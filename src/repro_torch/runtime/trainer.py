"""Fault-tolerant training loop (the reference's `runtime/trainer.py`),
eager on one device.

  * A train step: the loss and its gradients (autograd; with microbatches,
    each microbatch's l/n and g/n added in f32 in microbatch order), the
    global-norm clip, optional int8 gradient compression with error
    feedback (one scale per reference leaf: a layer stack's leaf path
    shares one), then the optimizer (optim.adamw / adafactor).
  * Atomic keep-N checkpoints every `checkpoint_every` steps, and
    auto-resume: `run()` survives preemptions (PreemptionError, injected by
    the tests) by restoring the newest checkpoint and going on — bitwise
    identically, since the data is a pure function of (seed, step) and the
    step is deterministic (models.common's gathers add their gradients in
    a fixed order). A checkpoint written by the reference's
    CheckpointManager (stacked layer leaves) resumes as well
    (`registry.state_from_numpy`).
  * A straggler watchdog: each step's wall time against the running median
    of the last 32; slow steps are recorded.
  * On an active mesh (`parallel.sharding.set_mesh`) the state lives
    sharded, as the reference's lives on its rule tree's NamedShardings:
    each rank holds only its block of every leaf (the params, AdamW's m /
    v or Adafactor's vr / vc / v, the error-feedback buffers), cut by
    `sharding.tree_param_specs` (`state_specs`). The step reads the params
    inside `sharding.placed_state`: each layer is gathered whole when it
    runs and dropped after (`sharding.gathered` in the models), the
    gradients come back as blocks, and the clip, the compression and the
    optimizer run on blocks (a reduction over a cut dim sums over the
    shards in rank order; the int8 scale is a max over them, exact).
    Every rank computes the whole step on the whole batch (activations
    stay whole), so adding ranks adds capacity for the state, not speed.
    Rank 0 writes each checkpoint whole, every rank joining the gather of
    each leaf in turn, and every rank restores its own blocks from it
    (the port's checkpoints and the reference's stacked ones). Without a
    mesh, on a 1-rank mesh, or with the test hook `shard_state=False`,
    every rank holds the whole state and the step is the same bits as
    before. The ranks meet at a barrier after each save and each restore.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.ckpt import load_numpy_tree
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.data.tokens import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.optim import (adafactor, adamw, apply_updates,
                               cosine_warmup, global_norm_clip)
from repro_torch.optim.optimizers import (group_spec, group_tensor,
                                          set_group, stacked_groups,
                                          tree_leaves, tree_map)
from repro_torch.parallel import sharding
from repro_torch.parallel.collectives import compress_decompress


class PreemptionError(RuntimeError):
    """Raised to simulate a node preemption mid-run (tests)."""


def _mesh_rank() -> tuple[int, int]:
    """(this rank, the world size) while a mesh is active, (0, 1)
    without."""
    if sharding.get_mesh() is None or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _meet() -> None:
    """A barrier of the mesh's ranks (none over one rank)."""
    if _mesh_rank()[1] > 1:
        dist.barrier()


def make_optimizer(tc: TrainConfig):
    lr = cosine_warmup(tc.lr, tc.warmup_steps, tc.steps)
    if tc.optimizer == "adafactor":
        return adafactor(lr, weight_decay=tc.weight_decay)
    return adamw(lr, weight_decay=tc.weight_decay)


def value_and_grad(loss_fn: Callable, params, batch, specs=None):
    """(loss, grads in each parameter's dtype) of loss_fn(params, batch). A
    parameter the loss does not read gets zeros, as jax.grad gives it
    (zamba2 cut below `shared_every` layers never applies its shared
    block). With `specs` the params are placed blocks: the loss and its
    backward run inside `sharding.placed_state`, and the gradients are
    blocks too."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    it = iter(live)
    tracked = tree_map(lambda _: next(it), params)
    with sharding.placed_state(tracked, specs):
        loss = loss_fn(tracked, batch)
        grads = iter(torch.autograd.grad(loss, live, allow_unused=True))

    def grad_of(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), tree_map(grad_of, params)


def _compress(grads, err, specs=None):
    """compress_decompress over each reference leaf (a layer stack's leaf
    path stacked into one [L, ...] tensor, as the reference's stacked leaf
    shares one int8 scale): (grads, new error buffers). With `specs` the
    leaves are blocks, and each scale is the max over the shards."""
    out_g = tree_map(lambda _: None, grads)
    out_e = tree_map(lambda _: None, grads)
    for path, members in stacked_groups(grads):
        spec = group_spec(specs, members, path)
        y, e = compress_decompress(group_tensor(grads, members, path),
                                   group_tensor(err, members, path),
                                   sharding.spec_axes(spec) if spec else ())
        set_group(out_g, members, path, y)
        set_group(out_e, members, path, e)
    return out_g, out_e


def state_specs(cfg: ModelConfig, tc: TrainConfig, max_seq: int = 0):
    """The spec tree of a train state {"params", "opt", ("err")} on the
    active mesh (the rule tree, `sharding.tree_param_specs`, of the
    state's whole shapes, made on the meta device), or None where it cuts
    no leaf (no mesh, a 1-rank mesh): the state is then whole."""
    params = registry.abstract_params(cfg, max_seq=max_seq)
    state = {"params": params, "opt": make_optimizer(tc).init(params)}
    if tc.grad_compression:
        state["err"] = params
    specs = sharding.tree_param_specs(state)
    return specs if sharding.any_cut(specs) else None


def make_train_step(cfg: ModelConfig, tc: TrainConfig, specs=None):
    """Returns (step, opt): step(state, batch) → (state, metrics {"loss",
    "grad_norm"} as f32 tensors); state is a dict {"params", "opt",
    ("err")}, err the compression error-feedback buffers. A step writes new
    tensors and never its input state. The reference's step also takes a
    PRNG key, which no ported loss draws from. `specs` (`state_specs`):
    the state is placed, each leaf this rank's block (module docstring);
    None: the state is whole."""
    mod = registry.get_module(cfg)
    opt = make_optimizer(tc)
    pspecs = specs["params"] if specs is not None else None

    def loss_fn(params, batch):
        return mod.train_loss(params, batch, cfg, None)

    def grads_of(params, batch):
        b = batch["tokens"].shape[0]
        if not (tc.microbatch and tc.microbatch < b):
            return value_and_grad(loss_fn, params, batch, pspecs)
        if b % tc.microbatch:
            raise ValueError(f"batch {b} does not split into microbatches "
                             f"of {tc.microbatch}")
        n = b // tc.microbatch
        dev = batch["tokens"].device
        acc_l = torch.zeros((), dtype=torch.float32, device=dev)
        acc_g = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for i in range(n):
            mb = {k: v[i * tc.microbatch:(i + 1) * tc.microbatch]
                  for k, v in batch.items()}
            loss, g = value_and_grad(loss_fn, params, mb, pspecs)
            acc_l = acc_l + loss / torch.full((), float(n), device=dev)
            acc_g = tree_map(
                lambda a, x: a + x / torch.full((), n, dtype=x.dtype,
                                                device=x.device), acc_g, g)
        return acc_l, acc_g

    def step(state, batch):
        params, opt_state = state["params"], state["opt"]
        loss, grads = grads_of(params, batch)
        with torch.no_grad():
            grads, gnorm = global_norm_clip(grads, tc.grad_clip, pspecs)
            if tc.grad_compression:
                grads, new_err = _compress(grads, state["err"], pspecs)
            updates, opt_state = opt.update(grads, opt_state, params,
                                            specs=pspecs)
            params = apply_updates(params, updates)
        new_state = {"params": params, "opt": opt_state}
        if tc.grad_compression:
            new_state["err"] = new_err
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step, opt


@dataclasses.dataclass
class Trainer:
    cfg: ModelConfig
    shape: ShapeConfig
    tc: TrainConfig
    ckpt_dir: str
    preempt_at: Optional[int] = None      # test hook: raise at this step
    straggler_factor: float = 3.0
    device: object = None                 # None: the card
    shard_state: bool = True              # test hook: False keeps the
    #                                       whole state on a mesh

    def __post_init__(self):
        self.dev = resolve_device(self.device)
        self.mgr = CheckpointManager(self.ckpt_dir,
                                     keep=self.tc.keep_checkpoints)
        # the placement follows the mesh active now
        self.specs = state_specs(self.cfg, self.tc, self._max_seq()) \
            if self.shard_state and sharding.get_mesh() is not None else None
        self.step_fn, self.opt = make_train_step(self.cfg, self.tc,
                                                 self.specs)
        self.data = SyntheticLMDataset(self.cfg.vocab, self.shape.seq_len,
                                       self.shape.global_batch,
                                       seed=self.tc.seed)
        self.metrics_log: list[dict] = []
        self.straggler_steps: list[int] = []

    def _max_seq(self) -> int:
        return self.shape.seq_len + 8

    def init_state(self) -> dict:
        """The seeded params (placed: this rank's blocks, the whole tensors
        freed) and the optimizer's and error feedback's zeros of their
        shapes."""
        params = registry.init_params(self.cfg, seed=self.tc.seed,
                                      device=self.dev,
                                      max_seq=self._max_seq())
        if self.specs is not None:
            params = sharding.tree_place(params, self.specs["params"])
        state = {"params": params, "opt": self.opt.init(params)}
        if self.tc.grad_compression:
            state["err"] = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
        return state

    def _restore_or_init(self):
        latest = self.mgr.latest_step()
        if latest is None:
            return self.init_state(), 0
        tree, md = load_numpy_tree(
            self.mgr.step_dir(latest),
            specs=sharding.leaf_spec if self.specs is not None else None)
        state = registry.state_from_numpy(tree, self.cfg, self.dev)
        _meet()           # every rank has read it before rank 0 writes on
        return state, int(md["step"])

    def batch(self, step: int) -> dict:
        return {k: torch.from_numpy(v).to(self.dev)
                for k, v in self.data.batch(step).items()}

    def run_once(self) -> dict:
        """One attempt (may raise PreemptionError)."""
        state, start = self._restore_or_init()
        times: list[float] = []
        for step in range(start, self.tc.steps):
            if self.preempt_at is not None and step == self.preempt_at:
                self.preempt_at = None  # only once
                raise PreemptionError(f"simulated preemption at step {step}")
            batch = self.batch(step)
            t0 = time.monotonic()
            state, metrics = self.step_fn(state, batch)
            if step % self.tc.log_every == 0 or step == self.tc.steps - 1:
                metrics = {k: float(v) for k, v in metrics.items()}
                self.metrics_log.append({"step": step, **metrics})
            dt = time.monotonic() - t0
            times.append(dt)
            med = float(np.median(times[-32:]))
            if len(times) > 4 and dt > self.straggler_factor * med:
                self.straggler_steps.append(step)
            last_step = step + 1
            if last_step % self.tc.checkpoint_every == 0 \
                    or last_step == self.tc.steps:
                # placed: every rank joins each leaf's gather, rank 0
                # writes; whole: rank 0 alone
                if self.specs is not None or _mesh_rank()[0] == 0:
                    self.mgr.save(last_step, state, specs=self.specs,
                                  write=_mesh_rank()[0] == 0)
                _meet()
        return {"state": state, "final_step": self.tc.steps,
                "metrics": self.metrics_log}

    def run(self, max_restarts: int = 4) -> dict:
        """Auto-resume loop: restart from the newest checkpoint on failure."""
        for attempt in range(max_restarts + 1):
            try:
                return self.run_once()
            except PreemptionError:
                if attempt == max_restarts:
                    raise
                continue
        raise RuntimeError("unreachable")
