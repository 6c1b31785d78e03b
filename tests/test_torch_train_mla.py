"""Training of deepseek-v3-671b in the port (ROADMAP A10b) against the
reference package at --cim off: MLA under `train`, the leading dense
layers before the MoE layers, the load-balance losses summed over the
stacks, the MTP loss, a reference Adafactor checkpoint resumed in the
port's Trainer, and the model cut to its dense layers. The --cim bp
leg is test_torch_train_mla_bp.py, the MoE FFN's own legs and the
Trainer's are test_torch_train_moe.py: the reference runs op by op, and
each of its first gradient passes compiles every op it meets (40-60 s for
this model), so the files are split to keep each near a minute in one
process.

Weights come from a reference init carried across by `params_from_numpy`,
inputs from numpy seeds; the reference runs op by op (layers unrolled, no
remat, no jit) and is differentiated with jax.value_and_grad. The models
are the float32 smoke configs (1 dense layer, 2 MoE layers, MLA, MTP).

Tolerances (relative to the reference's largest |value|; measured):
  * train_loss: LOSS_TOL 1e-6 (measured 0 at off, 9.9e-8 at bp), every
    gradient TRAIN_GRAD_TOL 1e-5 (measured ≤ 3.7e-6); remat on vs off bit
    for bit;
  * MLA's output LOSS_TOL (measured ≤ 2.7e-7) and its gradients GRAD_TOL
    1e-5 (measured ≤ 6.1e-7);
  * the MTP loss alone (measured 0) and the summed aux (1.2e-7): LOSS_TOL;
  * the Trainer resuming a reference checkpoint: RESUME_TOL 1e-5 on the
    next 3 steps' losses (measured ≤ 1.2e-7; the reference's step is
    jitted).
"""
import numpy as np
import pytest
import torch

from _torch_helpers import (check_resume, check_train_loss, compare_grads,
                            leg_cfgs, np32, rel_err, to_numpy_tree)
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import SMOKES as REF_SMOKES  # noqa: E402
from repro.data.tokens import SyntheticLMDataset  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.models import mla, moe, registry, transformer  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa

LOSS_TOL = 1e-6
GRAD_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-5
RESUME_TOL = 1e-5
SEQ, BATCH = 16, 2
DS = "deepseek-v3-671b"


def reference_params():
    cfg = REF_SMOKES[DS].replace(dtype="float32")
    return ref_registry.init_params(jax.random.PRNGKey(0), cfg)


@pytest.fixture(scope="module")
def ref_params():
    return reference_params()


def _batch(step=0):
    return SyntheticLMDataset(512, SEQ, BATCH, seed=0).batch(step)


def check_deepseek_train_loss(ref_params, leg):
    """CE + 0.3 · MTP + 0.01 · aux and every gradient (the dense_layers
    stack, the MoE layers, MLA's seven projections and two norms, the mtp
    block, the shared embedding and head) against the reference's."""
    _, grads, _ = check_train_loss(ref_params, DS, leg, _batch(),
                                   loss_tol=LOSS_TOL,
                                   grad_tol=TRAIN_GRAD_TOL)
    assert {"dense_layers", "layers", "mtp"} <= set(grads)
    assert float(grads["mtp"]["proj"]["w_proj"].abs().max()) > 0
    assert float(grads["dense_layers"][0]["attn"]["w_uk"].abs().max()) > 0


def check_mla_apply(ref_params, leg):
    """MLA's full-sequence route under train (the first MoE layer's
    attention, at the model's batch and sequence): the output and the
    gradients of Σ c·y with respect to the input and every MLA weight."""
    rc, pc = leg_cfgs(DS, leg)
    rp = jax.tree.map(lambda a: a[0], ref_params["layers"]["attn"])
    tp = tree_map(lambda t: t.requires_grad_(), registry.params_from_numpy(
        to_numpy_tree(rp), pc, device="cpu"))
    rng = np.random.RandomState(8)
    x = rng.standard_normal((BATCH, SEQ, pc.d_model)).astype(np.float32)
    c = rng.standard_normal(x.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ), (BATCH, SEQ))

    def ref_f(p, xx):
        y, _ = ref_mla.apply(p, xx, rc, positions=jnp.asarray(pos),
                             train=True)
        return jnp.sum(y * c), y

    (_, ry), (rgp, rgx) = jax.value_and_grad(ref_f, argnums=(0, 1),
                                             has_aux=True)(rp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    y, _ = mla.apply(tp, tx, pc, positions=torch.from_numpy(pos.copy()),
                     train=True)
    assert rel_err(np32(y), np32(ry)) <= LOSS_TOL
    grads = torch.autograd.grad((y * torch.from_numpy(c)).sum(),
                                [tx] + tree_leaves(tp))
    assert rel_err(grads[0].numpy(), np32(rgx)) <= GRAD_TOL
    it = iter(grads[1:])
    assert compare_grads(tree_map(lambda _: next(it), tp), rgp) <= GRAD_TOL


def test_train_loss_and_gradients_match_reference(ref_params):
    check_deepseek_train_loss(ref_params, "off")


def test_mla_apply_train_gradients_match_reference(ref_params):
    check_mla_apply(ref_params, "off")


def test_mtp_loss_matches_reference(ref_params):
    """deepseek's MTP term alone (norm_h ∥ norm_e → w_proj → one block →
    the shared head, CE against labels[:, 1:]) on the reference's final
    hidden state."""
    rc, pc = leg_cfgs(DS, "off")
    b = _batch(1)
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    h, _, _ = ref_tf.forward(ref_params, rb, rc, train=True)
    r_mtp = ref_tf._mtp_loss(ref_params, h, rb, rc)
    p = registry.params_from_numpy(to_numpy_tree(ref_params), pc,
                                   device="cpu")
    t_mtp = transformer._mtp_loss(p, torch.from_numpy(np32(h)),
                                  {k: torch.from_numpy(v)
                                   for k, v in b.items()}, pc)
    assert abs(float(t_mtp) - float(r_mtp)) <= LOSS_TOL * float(r_mtp)


def test_forward_aux_sums_the_moe_layers(ref_params):
    """forward(train=True)'s aux: the MoE layers' losses summed in layer
    order (the dense layer adds 0), as the reference's scans."""
    rc, pc = leg_cfgs(DS, "off")
    b = _batch(2)
    _, raux, _ = ref_tf.forward(ref_params,
                                {k: jnp.asarray(v) for k, v in b.items()},
                                rc, train=True)
    p = registry.params_from_numpy(to_numpy_tree(ref_params), pc,
                                   device="cpu")
    _, aux, _ = transformer.forward(p, {k: torch.from_numpy(v)
                                        for k, v in b.items()}, pc,
                                    train=True)
    assert abs(float(aux) - float(raux)) <= LOSS_TOL * float(raux)
    assert float(aux) > 0


def test_reference_adafactor_checkpoint_resumes_in_port_trainer(tmp_path):
    """A reference Adafactor checkpoint resumes in the port's Trainer: the
    next 3 steps' losses within RESUME_TOL; every expert stack's factored
    statistics keep the reference's stacked layout, vr [L, E, K] and vc
    [L, E, M] over the last two axes."""
    state = check_resume(tmp_path, DS, "adafactor", SEQ, BATCH,
                         tol=RESUME_TOL)
    cfg = SMOKES[DS]
    st = state["opt"]["stats"]["layers"]["ffn"]["e_gate"]
    n_moe = cfg.n_layers - cfg.moe.first_dense
    e_pad = moe.padded_experts(cfg.moe.n_experts)
    assert st["vr"].shape == (n_moe, e_pad, cfg.d_model)
    assert st["vc"].shape == (n_moe, e_pad, cfg.moe.d_ff_expert)
    assert "mtp" in state["opt"]["stats"]


def test_empty_moe_stack_trains():
    """deepseek cut to its leading dense layers (n_layers = first_dense,
    as on the card): no MoE layer, aux 0, the optimizers skip the empty
    stack."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.runtime.trainer import make_train_step
    cfg = SMOKES[DS].replace(n_layers=1)
    params = registry.init_params(cfg, seed=0, device="cpu")
    assert params["layers"] == [] and len(params["dense_layers"]) == 1
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for opt in ("adamw", "adafactor"):
        step, o = make_train_step(cfg, TrainConfig(steps=4,
                                                   optimizer=opt))
        state, m = step({"params": params, "opt": o.init(params)}, b)
        assert np.isfinite(float(m["loss"]))
        assert state["params"]["layers"] == []
