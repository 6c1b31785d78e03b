"""Training of the MoE family in the port (ROADMAP A10b) against the
reference package: the expert STE (`cim_matmul_ste` on an expert stack,
per-expert gradients), `moe.apply(train=True)` with its load-balance loss
and a deterministic dispatch, `train_loss` with every gradient of
qwen2-moe-a2.7b, a reference AdamW checkpoint resumed in the port's
Trainer, and deterministic train steps. deepseek-v3's own legs (MLA, the
MTP loss, a reference Adafactor checkpoint) are test_torch_train_mla.py
and test_torch_train_mla_bp.py.

Weights come from a reference init carried across by `params_from_numpy`,
inputs from numpy seeds; the reference runs op by op (layers unrolled, no
remat, no jit) and is differentiated with jax.value_and_grad / jax.vjp.
The models are the float32 smoke configs.

Tolerances (relative to the reference's largest |value|; measured):
  * the expert STE: the forward bit for bit (B2e's plain version against
    the reference's vmap of its Pallas kernel), gx / gw STE_TOL 1e-6
    (measured 1.6e-7 and 0: f32 sums of the batched products; bf16 stacks
    round gw to bf16 on both sides);
  * moe.apply(train=True): y APPLY_TOL 1e-6 (measured ≤ 1.5e-7: the
    routing softmax and the router's f32 dot differ from XLA's in the last
    bit, tests/test_torch_moe.py), the load-balance loss AUX_TOL 1e-6
    (measured 0 here: its means are a sum then a division, and XLA:CPU
    may sum in another order), every gradient GRAD_TOL 1e-5 (measured ≤
    2.9e-7);
  * train_loss: LOSS_TOL 1e-6 (measured ≤ 2.1e-7), every gradient
    TRAIN_GRAD_TOL 1e-5 (measured ≤ 1.5e-6); per-layer remat on vs off bit
    for bit (`_torch_helpers.check_train_loss`). Under CIM no DAC code
    and no top-k choice moved at these inputs (a moved code would move
    the loss by a whole ADC step, ROADMAP Queue C);
  * the Trainer resuming a reference checkpoint: RESUME_TOL 1e-5 on the
    next 3 steps' losses (measured ≤ 7.5e-8; the reference's step is
    jitted).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from _torch_helpers import (check_resume, check_train_loss, compare_grads,
                            leg_cfgs, np32, rel_err, to_numpy_tree)
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import SMOKES as REF_SMOKES  # noqa: E402
from repro.core.macro import SimLevel as RefLevel  # noqa: E402
from repro.data.tokens import SyntheticLMDataset  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.core.macro import SimLevel  # noqa: E402
from repro_torch.models import moe, registry  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa
from repro_torch.runtime.trainer import make_train_step  # noqa: E402

ref_cm = importlib.import_module("repro.core.cim_matmul")
cm = importlib.import_module("repro_torch.core.cim_matmul")

STE_TOL = 1e-6
APPLY_TOL = 1e-6
AUX_TOL = 1e-6
GRAD_TOL = 1e-5
LOSS_TOL = 1e-6
TRAIN_GRAD_TOL = 1e-5
RESUME_TOL = 1e-5
SEQ, BATCH = 16, 2
MOE = "qwen2-moe-a2.7b"
DS = "deepseek-v3-671b"


@pytest.fixture(scope="module")
def ref_weights():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = REF_SMOKES[arch].replace(dtype="float32")
            cache[arch] = ref_registry.init_params(jax.random.PRNGKey(0), cfg)
        return cache[arch]
    return get


def _leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_()


def _require_grad(params):
    return tree_map(lambda p: p.requires_grad_(), params)


# ---------------------------------------------------------------------------
# the expert STE
# ---------------------------------------------------------------------------
def _cim_pair(level):
    out = []
    for mod, lv in ((ref_cm, RefLevel), (cm, SimLevel)):
        c = mod.CIMConfig(enabled=True,
                          noise_seed=None if level == "IDEAL" else 0)
        out.append(dataclasses.replace(c, macro=dataclasses.replace(
            c.macro, sim_level=getattr(lv, level))))
    return out


@pytest.mark.parametrize("level", ["IDEAL", "NOISY"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ste_gradients_match_jax_grad(level, dtype):
    """x [E, C, K] × an expert stack w [E, K, M] (f32, or bf16 as the
    model holds it): the port's one expert-batched call against the
    reference's vmap of cim_matmul_ste over the experts (w cast to f32
    inside, as models/moe.py does). The forward bit for bit; gx[e] =
    g[e]·w[e]ᵀ and gw[e] = x[e]ᵀ·g[e] per expert, gw in the stack's
    dtype."""
    rng = np.random.RandomState(3)
    e, c, k, m = 4, 6, 150, 24
    x = rng.randn(e, c, k).astype(np.float32)
    w = (rng.randn(e, k, m) * 0.05).astype(np.float32)
    w[1] *= 4.0                       # experts on scales of their own
    g = rng.randn(e, c, m).astype(np.float32)
    rc, pc = _cim_pair(level)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    wj = jnp.asarray(w).astype(jdt)
    ry, vjp = jax.vjp(jax.vmap(lambda xb, wb: ref_cm.cim_matmul_ste(
        xb, wb.astype(jnp.float32), rc)), jnp.asarray(x), wj)
    gx, gw = vjp(jnp.asarray(g))
    tx = _leaf(x)
    tw = torch.from_numpy(np32(wj)).to(getattr(torch, dtype)) \
        .requires_grad_()
    y = cm.cim_matmul_ste(tx, tw, pc)
    np.testing.assert_array_equal(np32(y), np.asarray(ry))
    (y * torch.from_numpy(g)).sum().backward()
    assert tw.grad.dtype == tw.dtype and tw.grad.shape == (e, k, m)
    assert rel_err(tx.grad.numpy(), np32(gx)) <= STE_TOL
    assert rel_err(np32(tw.grad), np32(gw)) <= STE_TOL
    # per expert: expert 2's gradient is its own product, rounded to the
    # stack's dtype (within one bf16 ulp, 2⁻⁸ relative, of the f32 one)
    gw2 = tx[2].detach().T @ torch.from_numpy(g[2])
    tol = STE_TOL if dtype == "float32" else 2.0 ** -8
    assert rel_err(np32(tw.grad[2]), gw2.numpy()) <= tol


# ---------------------------------------------------------------------------
# moe.apply under train
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("leg", ["off", "bp"])
def test_moe_apply_train_matches_reference(ref_weights, leg):
    """Layer 1's MoE FFN under train: y, the load-balance loss aux, and the
    gradients of Σ c·y + aux with respect to the input and every FFN
    weight (router, the three expert stacks, the gated shared expert)
    against jax.vjp of the reference's moe.apply(train=True)."""
    rc, pc = leg_cfgs(MOE, leg)
    rp = jax.tree.map(lambda a: a[1], ref_weights(MOE)["layers"]["ffn"])
    tp = _require_grad(registry.params_from_numpy(to_numpy_tree(rp), pc,
                                                  device="cpu"))
    rng = np.random.RandomState(4)
    x = rng.standard_normal((2, 12, pc.d_model)).astype(np.float32)
    c = rng.standard_normal(x.shape).astype(np.float32)

    def ref_f(p, xx):
        y, aux = ref_moe.apply(p, xx, rc, train=True)
        return jnp.sum(y * c) + aux, (y, aux)

    (_, (ry, raux)), (rgp, rgx) = jax.value_and_grad(
        ref_f, argnums=(0, 1), has_aux=True)(rp, jnp.asarray(x))
    tx = _leaf(x)
    y, aux = moe.apply(tp, tx, pc, train=True)
    assert y.shape == x.shape and aux.dtype == torch.float32
    assert rel_err(np32(y), np32(ry)) <= APPLY_TOL
    assert abs(float(aux) - float(raux)) <= AUX_TOL * float(raux)
    # the same y and aux at inference
    y_inf, aux_inf = moe.apply(tp, tx, pc)
    assert torch.equal(y_inf, y) and torch.equal(aux_inf, aux)
    total = (y * torch.from_numpy(c)).sum() + aux
    grads = torch.autograd.grad(total, [tx] + tree_leaves(tp))
    assert rel_err(grads[0].numpy(), np32(rgx)) <= GRAD_TOL
    it = iter(grads[1:])
    gtree = tree_map(lambda _: next(it), tp)
    assert compare_grads(gtree, rgp) <= GRAD_TOL
    # the router gets its gradient from the routing weights and from aux
    assert float(gtree["router"].abs().max()) > 0


def test_moe_dispatch_is_deterministic_and_order_free():
    """The dispatch's expand and the capacity buffers' gathers: two
    backward passes give the same bits, and a token's k cotangents are
    added in choice order."""
    x2 = torch.randn(5, 3, dtype=torch.float32, requires_grad=True)
    rep = moe._RepeatRows.apply(x2, 4)
    assert torch.equal(rep, x2.detach().repeat_interleave(4, 0))
    g = torch.randn(20, 3)
    (gx,) = torch.autograd.grad(rep, x2, g)
    g3 = g.reshape(5, 4, 3)
    want = ((g3[:, 0] + g3[:, 1]) + g3[:, 2]) + g3[:, 3]
    assert torch.equal(gx, want)
    table = torch.randn(7, 3, requires_grad=True)
    slot = torch.tensor([2, 6, 0, 6, 5, 6])    # 6: the overflow row
    out = moe._SlotGather.apply(table, slot)
    gs = torch.randn(6, 3)
    (gt,) = torch.autograd.grad(out, table, gs)
    assert torch.equal(gt[2], gs[0]) and torch.equal(gt[0], gs[2])
    assert torch.equal(gt[5], gs[4]) and not gt[6].any()
    assert not gt[1].any() and not gt[3].any()


# ---------------------------------------------------------------------------
# train_loss and the Trainer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("leg", ["off", "bp"])
def test_train_loss_and_gradients_match_reference(ref_weights, leg):
    """The float32 smoke model's loss (CE + 0.01 · the MoE layers' aux)
    and every gradient (router, expert stacks, shared expert, attention,
    norms, embedding and head) against jax.value_and_grad of the
    reference's train_loss; per-layer remat on vs off bit for bit."""
    b = SyntheticLMDataset(512, SEQ, BATCH, seed=0).batch(0)
    _, grads, _ = check_train_loss(ref_weights(MOE), MOE, leg, b,
                                   loss_tol=LOSS_TOL,
                                   grad_tol=TRAIN_GRAD_TOL)
    assert float(grads["layers"][0]["ffn"]["router"].abs().max()) > 0


def _tc(**kw):
    base = dict(steps=8, lr=1e-3, warmup_steps=2, checkpoint_every=4,
                log_every=1, keep_checkpoints=2)
    base.update(kw)
    return TrainConfig(**base)


def test_reference_checkpoint_resumes_in_port_trainer(tmp_path):
    """A reference AdamW checkpoint (m / v of every expert stack, stacked
    [L, E, K, M]) resumes in the port's Trainer: the next 3 steps' losses
    within RESUME_TOL of the reference's."""
    check_resume(tmp_path, MOE, "adamw", SEQ, BATCH, tol=RESUME_TOL)


@pytest.mark.parametrize("arch", [MOE, DS])
def test_train_step_is_deterministic(arch):
    """Two train steps from one state give the same bits (the MoE
    dispatch, the embedding gathers and the CE add without atomics), and
    the step leaves its input state as it was."""
    cfg = SMOKES[arch].replace(cim=cm.CIMConfig(enabled=True))
    step, opt = make_train_step(cfg, _tc())
    params = registry.init_params(cfg, seed=1, device="cpu")
    state = {"params": params, "opt": opt.init(params)}
    before = [t.clone() for t in tree_leaves(state)]
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLMDataset(cfg.vocab, SEQ, BATCH).batch(0).items()}
    s1, m1 = step(state, batch)
    s2, m2 = step(state, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s1),
                                                 tree_leaves(s2)))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state)))
    assert np.isfinite(float(m1["loss"])) and float(m1["grad_norm"]) > 0


def test_launch_train_runs_the_moe_arch(tmp_path, capsys):
    from repro_torch.launch import train
    train.main(["--arch", MOE, "--smoke", "--steps", "2", "--batch", "2",
                "--seq", "16", "--cim", "bp", "--device", "cpu", "--ckpt",
                str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("done: 2 steps; stragglers=[")
