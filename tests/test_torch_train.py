"""Training in the port (ROADMAP A10a) against the reference package: the
STE quantizers, gradients through every CIM backend, `cim_matmul_ste`,
`train_loss` of the dense archs and the KWS GRU (the other archs' legs,
A10b, are in test_torch_train_moe.py and test_torch_train_recurrent.py), the Trainer (resuming a
reference checkpoint, its own contracts) and the `launch.train` CLI.

Weights come from a reference init carried across by `params_from_numpy`,
inputs from numpy seeds; the reference runs op by op (layers unrolled, no
remat, no jit), as the other parity tests run it, and is differentiated
with jax.value_and_grad. The models are the float32 smoke configs.

Tolerances (relative to the reference's largest |value|; measured):
  * round_ste / clip_ste / adc_quantize gradients: bit for bit;
  * cim_matmul gradients at backend auto (the reference's Pallas
    custom_vjp, the port's plain kernel versions under the einsum VJP) and
    at backend "plain": GRAD_TOL 1e-6 at IDEAL and NOISY (measured 5.3e-7:
    the einsum backward's f32 sums), FULL_GRAD_TOL 1e-3 at FULL (measured
    2.8e-4: the INL curve's derivative multiplies torch's and XLA's
    last-bit sin / cos differences by its 12289-cycle jitter);
  * cim_matmul_ste: the forward bit for bit, gx / gw STE_TOL 1e-6
    (measured 2.1e-7 and 0);
  * train_loss: LOSS_TOL 1e-6 on the loss (measured ≤ 2.1e-7, one or two
    f32 ulps: torch's f32 exp / rsqrt and its sum order differ from
    XLA:CPU's in the last bit, so the CE's logsumexp and token mean are not
    bit for bit; under CIM no DAC code moves), TRAIN_GRAD_TOL 1e-5 on every
    gradient (measured ≤ 2.3e-6); remat on vs off bit for bit;
  * the GRU's train_loss under CIM: LOSS_TOL and TRAIN_GRAD_TOL (measured
    0 at IDEAL and 8.0e-8 at FULL on the loss, ≤ 4.9e-7 on the gradients);
  * the Trainer resuming a reference checkpoint: RESUME_TOL 1e-5 on the
    next 3 steps' losses (measured ≤ 1.5e-7; the reference's step is
    jitted).
"""
import dataclasses
import importlib
import json
import shutil

import numpy as np
import pytest
import torch

from _torch_helpers import (compare_grads, leg_cfgs, np32, rel_err,
                            to_numpy_tree)
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.configs.base import TrainConfig as RefTC  # noqa: E402
from repro.configs.registry import SMOKES as REF_SMOKES  # noqa: E402
from repro.core import adc as ref_adc  # noqa: E402
from repro.core import quant as ref_quant  # noqa: E402
from repro.core.macro import MacroConfig as RefMacro  # noqa: E402
from repro.core.macro import SimLevel as RefLevel  # noqa: E402
from repro.data.tokens import SyntheticLMDataset  # noqa: E402
from repro.models import gru as ref_gru  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.runtime.trainer import Trainer as RefTrainer  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.core import adc, quant  # noqa: E402
from repro_torch.core.macro import MacroConfig, SimLevel  # noqa: E402
from repro_torch.models import gru, registry  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa
from repro_torch.runtime.trainer import (PreemptionError,  # noqa: E402
                                         Trainer, make_train_step)

# the modules, not the functions the packages re-export under their names
ref_cm = importlib.import_module("repro.core.cim_matmul")
cm = importlib.import_module("repro_torch.core.cim_matmul")

GRAD_TOL = 1e-6
FULL_GRAD_TOL = 1e-3
STE_TOL = 1e-6
LOSS_TOL = 1e-6
TRAIN_GRAD_TOL = 1e-5
RESUME_TOL = 1e-5
SHAPE = ShapeConfig("tiny", 32, 4, "train")
SEQ, BATCH = 16, 2


# ---------------------------------------------------------------------------
# the STE quantizers and the CIM matmul's gradients
# ---------------------------------------------------------------------------
def _leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_()


def test_round_clip_adc_quantize_gradients_equal_jax_grad():
    rng = np.random.RandomState(0)
    v = (rng.randn(64) * 5).astype(np.float32)
    gr = jax.grad(lambda a: jnp.sum(ref_quant.clip_ste(
        ref_quant.round_ste(a), -3.0, 3.0) * v))(jnp.asarray(v))
    t = _leaf(v)
    (quant.clip_ste(quant.round_ste(t), -3.0, 3.0)
     * torch.from_numpy(v)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(gr))
    # off the autograd graph they are round and clamp themselves
    assert torch.equal(quant.round_ste(torch.from_numpy(v)),
                       torch.round(torch.from_numpy(v)))
    va = (np.abs(rng.randn(4, 3, 20)) * 3000).astype(np.float32)
    gr = jax.grad(lambda a: jnp.sum(ref_adc.adc_quantize(a, RefMacro())
                                    * va))(jnp.asarray(va))
    t = _leaf(va)
    (adc.adc_quantize(t, MacroConfig()) * torch.from_numpy(va)).sum() \
        .backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(gr))


def _cim_pair(level):
    out = []
    for mod, lv in ((ref_cm, RefLevel), (cm, SimLevel)):
        c = mod.CIMConfig(enabled=True,
                          noise_seed=None if level == "IDEAL" else 0)
        out.append(dataclasses.replace(c, macro=dataclasses.replace(
            c.macro, sim_level=getattr(lv, level))))
    return out


def _mm_inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(6, 300).astype(np.float32)
    w = (rng.randn(300, 40) * 0.05).astype(np.float32)
    c = rng.randn(6, 40).astype(np.float32)
    return x, w, c


@pytest.mark.parametrize("level", ["IDEAL", "NOISY", "FULL"])
@pytest.mark.parametrize("backend", ["auto", "plain"])
def test_cim_matmul_gradients_match_jax_grad(level, backend):
    """d Σ c·cim_matmul(x, w) / d(x, w): the reference's backend auto (its
    Pallas kernel's custom_vjp, IDEAL; the noisy kernel's under
    noise_seed 0) against the port's auto (the kernels' plain versions on
    the CPU, under _EinsumVJP) and plain backends. The forward is bit for
    bit."""
    x, w, c = _mm_inputs()
    rc, pc = _cim_pair(level)
    ry, vjp = jax.vjp(lambda a, b: ref_cm.cim_matmul(a, b, rc),
                      jnp.asarray(x), jnp.asarray(w))
    gx, gw = vjp(jnp.asarray(c))
    tx, tw = _leaf(x), _leaf(w)
    y = cm.cim_matmul(tx, tw, dataclasses.replace(pc, backend=backend))
    assert y.grad_fn is not None        # the kernel output is not detached
    np.testing.assert_array_equal(np32(y), np.asarray(ry))
    (y * torch.from_numpy(c)).sum().backward()
    tol = FULL_GRAD_TOL if level == "FULL" else GRAD_TOL
    assert rel_err(tx.grad.numpy(), np.asarray(gx)) <= tol
    assert rel_err(tw.grad.numpy(), np.asarray(gw)) <= tol


@pytest.mark.parametrize("level", ["IDEAL", "NOISY"])
def test_prequant_gradient_reaches_the_activations(level):
    """Stored codes (nibble-packed: B1 / B6's plain versions) carry no
    gradient; the activations' matches the reference's custom_vjp."""
    x, w, c = _mm_inputs(1)
    rc, pc = _cim_pair(level)
    rq, rs = ref_cm.quantize_weight_offline(jnp.asarray(w), rc)
    rq = ref_ops.pack_codes(rq)
    pq, ps = cm.quantize_weight_offline(torch.from_numpy(w), pc)
    pq = ops.pack_codes(pq)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    gr = jax.grad(lambda a: jnp.sum(ref_cm.cim_matmul_prequant(
        a, rq, rs, rc) * c))(jnp.asarray(x))
    tx = _leaf(x)
    (cm.cim_matmul_prequant(tx, pq, ps, pc)
     * torch.from_numpy(c)).sum().backward()
    assert pq.dtype == torch.uint8 and pq.grad is None
    assert rel_err(tx.grad.numpy(), np.asarray(gr)) <= GRAD_TOL


@pytest.mark.parametrize("level", ["IDEAL", "FULL"])
def test_cim_matmul_ste_matches_reference(level):
    x, w, c = _mm_inputs(2)
    rc, pc = _cim_pair(level)
    ry, vjp = jax.vjp(lambda a, b: ref_cm.cim_matmul_ste(a, b, rc),
                      jnp.asarray(x), jnp.asarray(w))
    gx, gw = vjp(jnp.asarray(c))
    tx, tw = _leaf(x), _leaf(w)
    y = cm.cim_matmul_ste(tx, tw, pc)
    np.testing.assert_array_equal(np32(y), np.asarray(ry))
    (y * torch.from_numpy(c)).sum().backward()
    assert rel_err(tx.grad.numpy(), np.asarray(gx)) <= STE_TOL
    assert rel_err(tw.grad.numpy(), np.asarray(gw)) <= STE_TOL
    # CIM off: the float matmul
    off = dataclasses.replace(pc, enabled=False)
    assert torch.equal(cm.cim_matmul_ste(tx, tw, off), tx @ tw)


# ---------------------------------------------------------------------------
# train_loss of the dense archs
# ---------------------------------------------------------------------------
def _batch(vocab, step=0):
    return SyntheticLMDataset(vocab, SEQ, BATCH, seed=0).batch(step)


@pytest.fixture(scope="module")
def ref_weights():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = REF_SMOKES[arch].replace(dtype="float32")
            cache[arch] = ref_registry.init_params(jax.random.PRNGKey(0), cfg)
        return cache[arch]
    return get


def _grads_tree(params, loss):
    leaves = tree_leaves(params)
    grads = iter(torch.autograd.grad(loss, leaves))
    return tree_map(lambda _: next(grads), params)


def _require_grad(params):
    return tree_map(lambda p: p.requires_grad_(), params)


@pytest.mark.parametrize("arch,leg,ce", [
    ("internlm2-1.8b", "off", 1), ("internlm2-1.8b", "off", 2),
    ("internlm2-1.8b", "bp", 1), ("internlm2-1.8b", "bp", 2),
    ("llama3-8b", "off", 1), ("llama3-8b", "bp", 2)])
def test_train_loss_and_gradients_match_reference(ref_weights, arch, leg,
                                                  ce):
    """The float32 smoke model's loss and every gradient against
    jax.value_and_grad of the reference's train_loss (op by op); per-layer
    remat (torch.utils.checkpoint) gives the same loss and gradients bit
    for bit."""
    rc, pc = leg_cfgs(arch, leg)
    rc, pc = rc.replace(remat=False, ce_chunks=ce), pc.replace(ce_chunks=ce)
    rp = ref_weights(arch)
    b = _batch(rc.vocab)
    rl, rg = jax.value_and_grad(ref_tf.train_loss)(
        rp, {k: jnp.asarray(v) for k, v in b.items()}, rc)
    tree = to_numpy_tree(rp)
    out = {}
    for remat in (True, False):
        c = pc.replace(remat=remat)
        p = _require_grad(registry.params_from_numpy(tree, c, device="cpu"))
        loss = registry.train_loss(p, {k: torch.from_numpy(v)
                                       for k, v in b.items()}, c)
        out[remat] = (loss.detach(), _grads_tree(p, loss))
    assert torch.equal(out[True][0], out[False][0])
    for a, g in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        assert torch.equal(a, g)
    loss, grads = out[True]
    assert abs(float(loss) - float(rl)) <= LOSS_TOL * abs(float(rl))
    assert compare_grads(grads, rg) <= TRAIN_GRAD_TOL


# ---------------------------------------------------------------------------
# the KWS GRU under CIM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("level", ["IDEAL", "FULL"])
def test_gru_train_loss_under_cim_matches_reference(level):
    rc, pc = _cim_pair(level)
    ref_cfg = ref_gru.gru_config(cim=rc, n_classes=4)
    cfg = gru.gru_config(cim=pc, n_classes=4)
    rp = ref_gru.init(jax.random.PRNGKey(3), ref_cfg)
    rng = np.random.RandomState(0)
    x = np.maximum(rng.standard_normal((16, 4, 144)), 0).astype(np.float32)
    y = rng.randint(0, 4, 16)
    rl, rg = jax.value_and_grad(ref_gru.train_loss)(
        rp, {"frames": jnp.asarray(x), "labels": jnp.asarray(y)}, ref_cfg)
    p = _require_grad(registry.params_from_numpy(to_numpy_tree(rp), cfg,
                                                 device="cpu"))
    loss = gru.train_loss(p, {"frames": torch.from_numpy(x),
                              "labels": torch.from_numpy(y)}, cfg)
    grads = _grads_tree(p, loss)
    assert abs(float(loss.detach()) - float(rl)) <= LOSS_TOL * abs(float(rl))
    for k, g in grads.items():
        assert rel_err(np32(g), np.asarray(rg[k])) <= TRAIN_GRAD_TOL, k


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------
def _tc(cls=TrainConfig, **kw):
    base = dict(steps=8, lr=1e-3, warmup_steps=2, checkpoint_every=4,
                log_every=1, keep_checkpoints=2)
    base.update(kw)
    return cls(**base)


def test_reference_checkpoint_resumes_in_port_trainer(tmp_path):
    """The reference Trainer runs 2 steps and checkpoints; from a copy of
    that directory the port's Trainer and the reference's each take the
    next 3 steps: losses within RESUME_TOL, the AdamW step count
    carried."""
    ref_cfg = REF_SMOKES["internlm2-1.8b"].replace(dtype="float32")
    cfg = SMOKES["internlm2-1.8b"].replace(dtype="float32")
    shape = RefShape("tiny", SEQ, BATCH, "train")
    RefTrainer(ref_cfg, shape, _tc(RefTC, steps=2, checkpoint_every=2),
               str(tmp_path / "ref")).run()
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    ref_out = RefTrainer(ref_cfg, shape, _tc(RefTC, steps=5),
                         str(tmp_path / "ref")).run()
    tr = Trainer(cfg, ShapeConfig("tiny", SEQ, BATCH, "train"),
                 _tc(steps=5), str(tmp_path / "port"), device="cpu")
    out = tr.run()
    assert [m["step"] for m in out["metrics"]] == [2, 3, 4]
    assert [m["step"] for m in ref_out["metrics"]] == [2, 3, 4]
    for a, b in zip(out["metrics"], ref_out["metrics"]):
        assert abs(a["loss"] - b["loss"]) <= RESUME_TOL * abs(b["loss"])
    assert int(out["state"]["opt"]["step"]) == 5
    # the port's own checkpoint of step 5 holds per-layer leaves
    assert tr.mgr.latest_step() == 5


def test_loss_decreases(tmp_path):
    out = Trainer(SMOKES["internlm2-1.8b"], SHAPE, _tc(steps=20),
                  str(tmp_path), device="cpu").run()
    losses = [m["loss"] for m in out["metrics"]]
    assert losses[-1] < losses[0] - 0.1


@pytest.mark.parametrize("cim", ["off", "bp"])
def test_preemption_restart_is_bitwise_identical(tmp_path, cim):
    """Killed at step 5 and resumed from the step-4 checkpoint, the run
    ends in the uninterrupted run's loss and parameters, bit for bit."""
    cfg = SMOKES["internlm2-1.8b"]
    if cim == "bp":
        cfg = cfg.replace(cim=cm.CIMConfig(enabled=True))
    clean = Trainer(cfg, SHAPE, _tc(), str(tmp_path / "a"),
                    device="cpu").run()
    resumed = Trainer(cfg, SHAPE, _tc(), str(tmp_path / "b"),
                      preempt_at=5, device="cpu").run()
    assert clean["metrics"][-1] == resumed["metrics"][-1]
    for a, b in zip(tree_leaves(clean["state"]["params"]),
                    tree_leaves(resumed["state"]["params"])):
        assert torch.equal(a, b)


def test_preemption_without_restart_budget_raises(tmp_path):
    tr = Trainer(SMOKES["internlm2-1.8b"], SHAPE, _tc(), str(tmp_path),
                 preempt_at=2, device="cpu")
    with pytest.raises(PreemptionError):
        tr.run(max_restarts=0)


def test_microbatch_accumulation_matches_full_batch():
    """Accumulating 2 microbatches ≈ the full-batch step (f32)."""
    cfg = SMOKES["internlm2-1.8b"].replace(dtype="float32", remat=False)
    step_full, opt = make_train_step(cfg, _tc(microbatch=0))
    step_micro, _ = make_train_step(cfg, _tc(microbatch=2))
    params = registry.init_params(cfg, seed=0, device="cpu", max_seq=40)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLMDataset(cfg.vocab, 32, 4).batch(0).items()}
    _, m1 = step_full({"params": params, "opt": opt.init(params)}, batch)
    _, m2 = step_micro({"params": params, "opt": opt.init(params)}, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)


def test_grad_compression_trains(tmp_path):
    out = Trainer(SMOKES["internlm2-1.8b"], SHAPE,
                  _tc(steps=12, grad_compression=True), str(tmp_path),
                  device="cpu").run()
    losses = [m["loss"] for m in out["metrics"]]
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0]
    assert "err" in out["state"]


def test_launch_train_smoke_prints_the_reference_format(tmp_path, capsys):
    from repro_torch.launch import train
    train.main(["--arch", "internlm2-1.8b", "--smoke", "--steps", "3",
                "--batch", "2", "--seq", "16", "--cim", "bp", "--device",
                "cpu", "--ckpt", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(x) for x in lines[:-1]]
    assert [list(r) for r in rows] == [["step", "loss", "grad_norm"]] * 2
    assert [r["step"] for r in rows] == [0, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert lines[-1].startswith("done: 3 steps; stragglers=[")


def test_train_cim_qat_example_runs(capsys):
    from repro_torch.examples import train_cim_qat
    train_cim_qat.main(["--steps", "3", "--batch", "2", "--seq", "16",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[float] first=" in out and "[cim_bp] first=" in out
    assert "final-loss gap (CIM-QAT − float):" in out
