"""Shared helpers of the tests that hold the PyTorch port against the JAX
reference package: dataclass normalization, weight transfer, the float32
smoke configs of a CIM leg and the slot Server's mixed-length schedule."""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One intra-op thread in each test of a module that imports this
    fixture: the suite runs several test processes on the machine's cores,
    and their thread pools otherwise oversubscribe them (thousands of small
    eager ops slow by tens of times). Each comparison runs both sides at
    one thread count; restored after."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def normalize(obj):
    """A dataclass tree as plain data (enums by value), so configs of the
    two packages compare field by field."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: normalize(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, tuple):
        return tuple(normalize(o) for o in obj)
    return obj


def to_numpy_tree(tree):
    """A JAX parameter tree → nested dict of numpy arrays, bf16 as uint16
    views (the checkpoint format's encoding)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    return a


def np32(t):
    """A torch tensor (any float dtype) or a JAX array → f32 numpy."""
    if hasattr(t, "detach"):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def gpu_device():
    """The CUDA device, or skip the calling test when there is none."""
    import pytest
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def rel_err(a, b) -> float:
    """max |a − b| relative to the largest |b| (at least 1e-6)."""
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def leg_cfgs(arch: str, leg: str):
    """(reference cfg, port cfg) of the float32 smoke `arch` for a leg:
    "off", "bp" (IDEAL) or "bp-noisy" (NOISY, noise_seed 0, as serve.py
    builds it); the reference's layers unrolled (op by op when not
    jitted)."""
    from repro.configs.registry import SMOKES as REF_SMOKES
    from repro.core.cim_matmul import CIMConfig as RefCIM
    from repro.core.macro import SimLevel as RefLevel
    from repro_torch.configs.registry import SMOKES
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.core.macro import SimLevel
    ref = REF_SMOKES[arch].replace(dtype="float32", scan_layers=False)
    port = SMOKES[arch].replace(dtype="float32")
    if leg == "off":
        return ref, port
    out = []
    for cfg, cim_cls, level in ((ref, RefCIM, RefLevel),
                                (port, CIMConfig, SimLevel)):
        cim = cim_cls(enabled=True)
        if leg == "bp-noisy":
            cim = dataclasses.replace(
                cim_cls(enabled=True, noise_seed=0),
                macro=dataclasses.replace(cim.macro,
                                          sim_level=level.NOISY))
        out.append(cfg.replace(cim=cim))
    return tuple(out)


def mixed_depth(srv, req_cls):
    """The slot tests' randomized admission on a Server (either package):
    5 requests of 3–8 prompt tokens and 2–5 new tokens, submitted at steps
    0, 0, 2, 3 and 7. Returns the streams."""
    rng = np.random.RandomState(42)
    schedule = {0: 2, 2: 1, 3: 1, 7: 1}
    reqs, step = [], 0
    while reqs == [] or any(not r.done for r in reqs) or srv.queue:
        for _ in range(schedule.get(step, 0)):
            n = int(rng.randint(3, 9))
            r = req_cls(prompt=rng.randint(0, 512, size=n).tolist(),
                        max_new_tokens=int(rng.randint(2, 6)))
            srv.submit(r)
            reqs.append(r)
        srv.step()
        step += 1
        assert step < 200
    return [r.output for r in reqs]


def walk_leaves(node, prefix=()):
    """(path, leaf) over a tree of dicts (and lists, by index)."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from walk_leaves(v, prefix + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from walk_leaves(v, prefix + (i,))
    else:
        yield prefix, node


# a key bias's gradient is zero in exact arithmetic (softmax cancels a
# per-query constant): both packages give rounding noise, held below this
# share of the tree's largest gradient instead of against each other
ZERO_GRAD_LEAVES = ("bk",)
ZERO_GRAD_BOUND = 1e-7


def compare_grads(port_g, ref_g, floor: float = 0.0,
                  zero: tuple = ZERO_GRAD_LEAVES) -> float:
    """The largest rel_err of a port gradient tree against the reference's
    (a JAX tree, or one already as numpy). A layer stack of the port (a
    list: "dense_layers", "layers", "enc_layers") is held layer by layer
    against the reference's stacked [L, ...] leaf; every other entry
    ("tok", "final_norm", "mtp", zamba2's "shared", whisper's "enc_norm",
    "enc_pos", "dec_pos", ...) leaf for leaf. Every reference leaf must
    have its port counterpart and the other way round.

    Each leaf's error is relative to its reference's largest |value|, or,
    with `floor` > 0, to at least floor × the largest |value| of the whole
    reference tree: a gradient ~1e-6 of the tree's scale (a sum with heavy
    cancellation) is then held on the tree's scale, not on its own
    rounding noise. A leaf named in `zero` (ZERO_GRAD_LEAVES) is zero in
    exact arithmetic: both sides must stay below ZERO_GRAD_BOUND × the
    tree's largest; pass zero=() to hold a tree that is no gradient."""
    ref_np = to_numpy_tree(ref_g) if not _is_numpy_tree(ref_g) else ref_g
    tree_max = max(float(np.max(np.abs(a))) for _, a in walk_leaves(ref_np))
    scale = floor * tree_max
    worst = 0.0
    port_paths = set()
    for path, g in walk_leaves(port_g):
        r, idx = ref_np, None
        for k in path:
            if isinstance(k, int):
                idx = k
            else:
                r = r[k]
        port_paths.add(tuple(k for k in path if not isinstance(k, int)))
        r = np.asarray(r if idx is None else r[idx], dtype=np.float32)
        if path[-1] in zero:
            assert max(float(np.max(np.abs(np32(g)))),
                       float(np.max(np.abs(r)))) \
                <= ZERO_GRAD_BOUND * tree_max, path
            continue
        err = float(np.max(np.abs(np32(g) - r)))
        worst = max(worst, err / max(float(np.max(np.abs(r))), scale, 1e-6))
    ref_paths = {p for p, _ in walk_leaves(ref_np)}
    assert ref_paths == port_paths, ref_paths ^ port_paths
    return worst


def _is_numpy_tree(tree) -> bool:
    return all(isinstance(a, np.ndarray) for _, a in walk_leaves(tree))


def check_train_loss(ref_params, arch: str, leg: str, batch: dict, *,
                     loss_tol: float, grad_tol: float, floor: float = 0.0):
    """`train_loss` and every gradient of the float32 smoke `arch` at a leg
    ("off" / "bp", `leg_cfgs`) against jax.value_and_grad of the
    reference's train_loss, op by op (remat off, layers unrolled, no jit);
    the port with per-layer remat on and off, which must agree bit for
    bit. `batch` holds numpy arrays (tokens / labels and any stub
    inputs); `floor` as in `compare_grads`. Returns (the port's loss, its
    gradient tree, the worst relative gradient error), after asserting
    both tolerances."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.models import registry as ref_registry
    from repro_torch.models import registry
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    rc, pc = leg_cfgs(arch, leg)
    rc = rc.replace(remat=False)
    rl, rg = jax.value_and_grad(ref_registry.get_module(rc).train_loss)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()}, rc)
    tree = to_numpy_tree(ref_params)
    out = {}
    for remat in (True, False):
        c = pc.replace(remat=remat)
        p = tree_map(lambda t: t.requires_grad_(),
                     registry.params_from_numpy(tree, c, device="cpu"))
        loss = registry.train_loss(p, {k: torch.from_numpy(np.array(v))
                                       for k, v in batch.items()}, c)
        grads = iter(torch.autograd.grad(loss, tree_leaves(p)))
        out[remat] = (loss.detach(), tree_map(lambda _: next(grads), p))
    assert torch.equal(out[True][0], out[False][0])
    for a, g in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        assert torch.equal(a, g)
    loss, grads = out[True]
    assert abs(float(loss) - float(rl)) <= loss_tol * abs(float(rl)), \
        (float(loss), float(rl))
    worst = compare_grads(grads, rg, floor)
    assert worst <= grad_tol, worst
    return loss, grads, worst


def check_resume(tmp_path, arch: str, opt: str, seq: int, batch: int, *,
                 tol: float):
    """The reference Trainer (float32 smoke `arch`, optimizer `opt`) runs 2
    steps and checkpoints; from a copy of that directory the port's
    Trainer and the reference's each take the next 3 steps: their losses
    within `tol`, the step count carried. Returns the port's final
    state."""
    import shutil
    from repro.configs.base import ShapeConfig as RefShape
    from repro.configs.base import TrainConfig as RefTC
    from repro.configs.registry import SMOKES as REF_SMOKES
    from repro.runtime.trainer import Trainer as RefTrainer
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import SMOKES
    from repro_torch.runtime.trainer import Trainer

    def tc(cls, **kw):
        base = dict(steps=5, lr=1e-3, warmup_steps=2, checkpoint_every=4,
                    log_every=1, keep_checkpoints=2, optimizer=opt)
        base.update(kw)
        return cls(**base)

    ref_cfg = REF_SMOKES[arch].replace(dtype="float32")
    shape = RefShape("tiny", seq, batch, "train")
    RefTrainer(ref_cfg, shape, tc(RefTC, steps=2, checkpoint_every=2),
               str(tmp_path / "ref")).run()
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    ref_out = RefTrainer(ref_cfg, shape, tc(RefTC),
                         str(tmp_path / "ref")).run()
    out = Trainer(SMOKES[arch].replace(dtype="float32"),
                  ShapeConfig("tiny", seq, batch, "train"), tc(TrainConfig),
                  str(tmp_path / "port"), device="cpu").run()
    assert [m["step"] for m in out["metrics"]] == [2, 3, 4]
    assert [m["step"] for m in ref_out["metrics"]] == [2, 3, 4]
    for a, b in zip(out["metrics"], ref_out["metrics"]):
        assert abs(a["loss"] - b["loss"]) <= tol * abs(b["loss"])
    assert int(out["state"]["opt"]["step"]) == 5
    return out["state"]
