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
  * On an active mesh (`parallel.sharding.set_mesh`) every rank holds the
    whole state (nothing is sharded at rest) and takes the same steps:
    rank 0 writes the checkpoints, the ranks meet at a barrier after each
    save and each restore, and every rank restores the whole state onto
    its own device (the reference restores onto the mesh's shardings).
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
from repro_torch.optim.optimizers import (group_tensor, set_group,
                                          stacked_groups, tree_leaves,
                                          tree_map)
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


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads in each parameter's dtype) of loss_fn(params, batch). A
    parameter the loss does not read gets zeros, as jax.grad gives it
    (zamba2 cut below `shared_every` layers never applies its shared
    block)."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    it = iter(live)
    tracked = tree_map(lambda _: next(it), params)
    loss = loss_fn(tracked, batch)
    grads = iter(torch.autograd.grad(loss, live, allow_unused=True))

    def grad_of(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), tree_map(grad_of, params)


def _compress(grads, err):
    """compress_decompress over each reference leaf (a layer stack's leaf
    path stacked into one [L, ...] tensor, as the reference's stacked leaf
    shares one int8 scale): (grads, new error buffers)."""
    out_g = tree_map(lambda _: None, grads)
    out_e = tree_map(lambda _: None, grads)
    for path, members in stacked_groups(grads):
        y, e = compress_decompress(group_tensor(grads, members, path),
                                   group_tensor(err, members, path))
        set_group(out_g, members, path, y)
        set_group(out_e, members, path, e)
    return out_g, out_e


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns (step, opt): step(state, batch) → (state, metrics {"loss",
    "grad_norm"} as f32 tensors); state is a dict {"params", "opt",
    ("err")}, err the compression error-feedback buffers. A step writes new
    tensors and never its input state. The reference's step also takes a
    PRNG key, which no ported loss draws from."""
    mod = registry.get_module(cfg)
    opt = make_optimizer(tc)

    def loss_fn(params, batch):
        return mod.train_loss(params, batch, cfg, None)

    def grads_of(params, batch):
        b = batch["tokens"].shape[0]
        if not (tc.microbatch and tc.microbatch < b):
            return value_and_grad(loss_fn, params, batch)
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
            loss, g = value_and_grad(loss_fn, params, mb)
            acc_l = acc_l + loss / torch.full((), float(n), device=dev)
            acc_g = tree_map(
                lambda a, x: a + x / torch.full((), n, dtype=x.dtype,
                                                device=x.device), acc_g, g)
        return acc_l, acc_g

    def step(state, batch):
        params, opt_state = state["params"], state["opt"]
        loss, grads = grads_of(params, batch)
        with torch.no_grad():
            grads, gnorm = global_norm_clip(grads, tc.grad_clip)
            if tc.grad_compression:
                grads, new_err = _compress(grads, state["err"])
            updates, opt_state = opt.update(grads, opt_state, params)
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

    def __post_init__(self):
        self.dev = resolve_device(self.device)
        self.mgr = CheckpointManager(self.ckpt_dir,
                                     keep=self.tc.keep_checkpoints)
        self.step_fn, self.opt = make_train_step(self.cfg, self.tc)
        self.data = SyntheticLMDataset(self.cfg.vocab, self.shape.seq_len,
                                       self.shape.global_batch,
                                       seed=self.tc.seed)
        self.metrics_log: list[dict] = []
        self.straggler_steps: list[int] = []

    def init_state(self) -> dict:
        params = registry.init_params(self.cfg, seed=self.tc.seed,
                                      device=self.dev,
                                      max_seq=self.shape.seq_len + 8)
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
        tree, md = load_numpy_tree(self.mgr.step_dir(latest))
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
                if _mesh_rank()[0] == 0:
                    self.mgr.save(last_step, state)
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
