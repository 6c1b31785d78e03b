"""Shared figure utilities: timing, the reference's f32 linspace, and a
small CIM-evaluated classifier.

The classifier stands in for the paper's CIFAR-10/ResNet-20 pipeline (no
datasets offline): an MLP trained in float on a synthetic Gaussian-cluster
task, then evaluated with every matmul routed through the simulated
PICO-RAM macro. Accuracy deltas across schemes / ADC bits / PVT corners
reproduce the paper's TRENDS (Figs. 1b, 10, 18, 19).

The task and the MLP's initial weights are drawn with numpy from the
reference's seeds (`seed`, and `seed + 100`); the reference draws them with
jax.random, so the two packages train on other draws of the same task. The
float training and the float evaluation are plain torch matmuls (the
reference computes them in jnp outside Pallas); the CIM evaluation is
`cim_matmul`, so at IDEAL the BP rows run kernel B2 on the card.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import CIMConfig, MacroConfig, cim_matmul
from repro_torch.core.adc import inl_instance
from repro_torch.core.quant import _f32
from repro_torch.device import resolve_device


def timeit(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median wall-time per call in microseconds; the device is
    synchronised after each call, so the time includes its work."""
    def call():
        fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    for _ in range(warmup):
        call()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(ts))


def row(name: str, us: float, derived) -> str:
    line = f"{name},{us:.1f},{derived}"
    print(line, flush=True)
    return line


def linspace0(stop: float, num: int, device) -> torch.Tensor:
    """jnp.linspace(0.0, stop, num) as XLA:CPU evaluates it in f32 (the
    reference's sweeps): the division by num − 1 becomes a multiply by its
    f32 reciprocal, folded into stop, so point i is i · f32(stop · f32(1 /
    (num − 1))) with one rounding, and the last point is stop itself."""
    step = np.float32(np.float32(stop) * (np.float32(1.0)
                                          / np.float32(num - 1)))
    i = torch.arange(num - 1, dtype=torch.float32, device=device)
    stop32 = torch.full((1,), stop, dtype=torch.float32, device=device)
    return torch.cat([i * float(step), stop32])


def inl_curve_eager(code_frac: torch.Tensor, amp_lsb: float,
                    seed: int = 0) -> torch.Tensor:
    """`core.adc.inl_curve` with each multiply and add rounded on its own,
    as the reference's curve evaluates op by op outside jit, where its
    figures call it; the core function keeps the jitted kernels' FMAs."""
    c = inl_instance(float(amp_lsb), int(seed))
    cf = code_frac.float()
    u = cf * 2.0 - 1.0
    xa = cf * c.two_pi
    curve = u * (u * u) * c.sign + c.ripple0 * torch.sin(
        xa * 2.0 + c.phase0) + c.ripple1 * torch.sin(xa * 3.0 + c.phase1)
    curve = curve / _f32(c.norm, cf)
    jitter = c.jitter * torch.sin(cf * 12289.0 + c.phase0) \
        * torch.sin(cf * 5741.0 + c.phase1)
    return c.bow * curve + jitter


# ---------------------------------------------------------------------------
# synthetic classification task evaluated on the simulated macro
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TaskData:
    x_train: torch.Tensor
    y_train: torch.Tensor
    x_test: torch.Tensor
    y_test: torch.Tensor


def make_task(n_classes=16, dim=64, n_train=4096, n_test=1024, seed=0,
              device=None) -> TaskData:
    """Gaussian clusters around centres N(0, 1.5²), rectified (the paper's
    non-negative activations); numpy RandomState(seed) draws the centres,
    then the train and the test (labels, then points)."""
    rng = np.random.RandomState(seed)
    centers = rng.standard_normal((n_classes, dim)) * 1.5

    def sample(n):
        y = rng.randint(0, n_classes, n)
        x = centers[y] + rng.standard_normal((n, dim))
        return np.maximum(x, 0.0).astype(np.float32), y.astype(np.int64)

    dev = resolve_device(device)
    xtr, ytr = sample(n_train)
    xte, yte = sample(n_test)
    return TaskData(*(torch.from_numpy(a).to(dev)
                      for a in (xtr, ytr, xte, yte)))


def init_mlp(dim: int, hidden: int, n_classes: int, seed: int,
             device) -> dict:
    """{"w1": [dim, hidden], "w2": [hidden, n_classes]}, f32, drawn N(0, 1)
    with numpy RandomState(seed) and scaled by 1/√fan-in."""
    rng = np.random.RandomState(seed)
    w1 = rng.standard_normal((dim, hidden)) / np.sqrt(dim)
    w2 = rng.standard_normal((hidden, n_classes)) / np.sqrt(hidden)
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in (("w1", w1), ("w2", w2))}


def _logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x @ p["w1"]) @ p["w2"]


def sgd(params: dict, task: TaskData, steps: int) -> dict:
    """Full-batch SGD on the mean cross-entropy, momentum 0.9 (m ← 0.9 m +
    g), lr 0.05 (p ← p − 0.05 m), gradients from torch.autograd."""
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    n = task.y_train.shape[0]
    rows = torch.arange(n, device=task.y_train.device)
    for _ in range(steps):
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        lg = _logits(leaves, task.x_train)
        loss = torch.mean(-torch.log_softmax(lg, -1)[rows, task.y_train])
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            m = {k: 0.9 * m[k] + g for k, g in zip(p, grads)}
            p = {k: p[k].detach() - 0.05 * m[k] for k in p}
    return p


def train_mlp(task: TaskData, hidden=144, steps=300, seed=0) -> dict:
    """Plain float training; CIM enters only at evaluation (PTQ deployment,
    the harder case than QAT — trends match the paper's)."""
    dim = task.x_train.shape[1]
    n_classes = int(task.y_train.max()) + 1
    params = init_mlp(dim, hidden, n_classes, seed + 100,
                      task.x_train.device)
    return sgd(params, task, steps)


@torch.no_grad()
def eval_accuracy(params, task: TaskData, macro: MacroConfig | None,
                  key: int | None = None) -> float:
    """Test accuracy with matmuls on the simulated macro (None = float).

    `key` is the counterpart of the reference's PRNGKey seed: where the
    reference splits its key in two, one per layer, the port seeds two
    torch.Generators on the task's device with 2·key and 2·key + 1. A
    key reaches the converter noise only away from IDEAL (no noise_seed:
    the einsum backend, as in the reference)."""
    if macro is None:
        lg = _logits(params, task.x_test)
    else:
        cfg = CIMConfig(enabled=True, macro=macro)
        k1 = k2 = None
        if key is not None:
            dev = task.x_test.device
            k1, k2 = (torch.Generator(device=dev) for _ in range(2))
            k1.manual_seed(2 * key)
            k2.manual_seed(2 * key + 1)
        h = torch.relu(cim_matmul(task.x_test, params["w1"], cfg, key=k1))
        lg = cim_matmul(h, params["w2"], cfg, key=k2)
    return float(torch.mean((torch.argmax(lg, -1) == task.y_test).float()))
