"""The paper's KWS GRU in the port (`models/gru.py`) against the reference
(`repro.models.gru`), on the reference's own weights carried across by
`params_from_numpy`, data from numpy seeds (64 sequences of 6 frames, 4
classes, as tests/test_gru.py sizes them).

Exact (bit for bit): each gate and head MVM on the same inputs at IDEAL
from float weights (B2) and from stored codes (B1), and at FULL with
noise_seed 0 (B5 / B6) at gain 3 and 0.65 V; the argmax of every forward.

Within a stated tolerance, relative to the largest |value| of the
reference's output: `gru_cell` and `forward` in float and on the macro
(TOL), and the parameters after 20 full-batch SGD steps of the float
model against the reference's jax.grad steps (SGD_TOL). torch's sigmoid
and tanh differ from XLA:CPU's in the last bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_helpers import np32, rel_err, to_numpy_tree
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.cim_matmul import CIMConfig as RefCIM  # noqa: E402
from repro.core.macro import PROTOTYPE as REF_PROTO  # noqa: E402
from repro.core.macro import OperatingPoint as RefOP  # noqa: E402
from repro.core.macro import SimLevel as RefLevel  # noqa: E402
from repro.models import gru as ref_gru  # noqa: E402
from repro.models.quantize import quantize_params as ref_quantize  # noqa
from repro_torch.core.cim_matmul import CIMConfig  # noqa: E402
from repro_torch.core.macro import PROTOTYPE, OperatingPoint, SimLevel  # noqa
from repro_torch.models import gru, registry  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402

# relative to the reference's largest |value|: measured up to 4.5e-7
# (float forward) and 1.8e-7 on the macro (no DAC code moved)
TOL = 1e-6
# parameters after 20 SGD steps: measured 1.8e-7
SGD_TOL = 1e-6
# (sim level, stored codes)
LEGS = [("ideal", False), ("ideal", True), ("full", False), ("full", True)]


@pytest.fixture(scope="module")
def model():
    cfg = ref_gru.gru_config(n_classes=4)
    params = ref_gru.init(jax.random.PRNGKey(3), cfg)
    rng = np.random.RandomState(0)
    proto = rng.standard_normal((4, 6, 144))
    y = rng.randint(0, 4, 64)
    x = np.maximum(proto[y] + 0.3 * rng.standard_normal((64, 6, 144)),
                   0.0).astype(np.float32)
    return params, to_numpy_tree(params), x, y


def _cfgs(level, stored, ref_p, np_p):
    """(reference cfg, port cfg, reference params, port params) on the
    macro at gain 3 and 0.65 V; FULL draws with noise_seed 0."""
    out = []
    for mk_cfg, cim_cls, proto, lv, op in (
            (ref_gru.gru_config, RefCIM, REF_PROTO, RefLevel, RefOP),
            (gru.gru_config, CIMConfig, PROTOTYPE, SimLevel,
             OperatingPoint)):
        macro = dataclasses.replace(proto, gain=3.0,
                                    sim_level=getattr(lv, level.upper()),
                                    op=op(vdd=0.65, temp_c=25.0))
        out.append(mk_cfg(n_classes=4, cim=cim_cls(
            enabled=True, macro=macro,
            noise_seed=0 if level == "full" else None)))
    rc, tc = out
    tp = registry.params_from_numpy(np_p, tc, device="cpu")
    if stored:
        return rc, tc, ref_quantize(ref_p, rc), quantize_params(tp, tc)
    return rc, tc, ref_p, tp


def test_init_shapes_fit_two_macro_groups():
    cfg = gru.gru_config()
    p = gru.init(cfg, seed=1, device="cpu")
    assert p["w_z"].shape == (288, 144) and 288 % PROTOTYPE.n_rows == 0
    assert p["head"].shape == (144, 16) and p["b_h"].shape == (144,)
    ref = ref_gru.init(jax.random.PRNGKey(1), ref_gru.gru_config())
    assert {k: tuple(v.shape) for k, v in p.items()} \
        == {k: v.shape for k, v in ref.items()}


def test_float_cell_and_forward_match_reference(model):
    ref_p, np_p, x, _ = model
    cfg, tp = gru.gru_config(n_classes=4), registry.params_from_numpy(
        np_p, gru.gru_config(n_classes=4), device="cpu")
    ref_cfg = ref_gru.gru_config(n_classes=4)
    h = np.random.RandomState(1).standard_normal((64, 144)) \
        .astype(np.float32)
    rh = ref_gru.gru_cell(ref_p, jnp.asarray(x[:, 0]), jnp.asarray(h),
                          ref_cfg, train=False)
    th = gru.gru_cell(tp, torch.from_numpy(x[:, 0]), torch.from_numpy(h),
                      cfg, train=False)
    assert rel_err(np32(th), np32(rh)) <= TOL
    rl = ref_gru.forward(ref_p, jnp.asarray(x), ref_cfg)
    tl = gru.forward(tp, torch.from_numpy(x), cfg)
    assert rel_err(np32(tl), np32(rl)) <= TOL
    assert np.array_equal(np32(tl).argmax(-1), np.asarray(rl).argmax(-1))


@pytest.mark.parametrize("level,stored", LEGS)
def test_gate_mvms_bit_exact(model, level, stored):
    """Each gate (and the head) MVM on the same numpy inputs gives the
    reference's output bit for bit."""
    ref_p, np_p, x, _ = model
    rc, tc, rp, tp = _cfgs(level, stored, ref_p, np_p)
    rng = np.random.RandomState(2)
    xh = np.concatenate([x[:, 2], np.tanh(rng.standard_normal(
        (64, 144)))], -1).astype(np.float32)
    for name, inp in (("w_z", xh), ("w_r", xh), ("w_h", xh),
                      ("head", xh[:, 144:])):
        r = ref_gru._mm(rp, name, jnp.asarray(inp), rc, False)
        t = gru._mm(tp, name, torch.from_numpy(inp), tc, False)
        assert np.array_equal(np32(t), np32(r)), name


@pytest.mark.parametrize("level,stored", LEGS)
def test_cim_cell_and_forward_match_reference(model, level, stored):
    ref_p, np_p, x, _ = model
    rc, tc, rp, tp = _cfgs(level, stored, ref_p, np_p)
    h = np.tanh(np.random.RandomState(3).standard_normal((64, 144))) \
        .astype(np.float32)
    rh = ref_gru.gru_cell(rp, jnp.asarray(x[:, 1]), jnp.asarray(h), rc,
                          train=False)
    th = gru.gru_cell(tp, torch.from_numpy(x[:, 1]), torch.from_numpy(h),
                      tc, train=False)
    assert rel_err(np32(th), np32(rh)) <= TOL
    rl = ref_gru.forward(rp, jnp.asarray(x), rc)
    tl = gru.forward(tp, torch.from_numpy(x), tc)
    assert rel_err(np32(tl), np32(rl)) <= TOL
    assert np.array_equal(np32(tl).argmax(-1), np.asarray(rl).argmax(-1))


def test_sgd_steps_match_jax_grad(model):
    """20 full-batch SGD steps (lr 0.1) of the float model: the port's
    autograd steps stay within SGD_TOL of the reference's jax.grad steps,
    and the loss falls as tests/test_gru.py asks."""
    from repro_torch.examples.kws_gru import train
    ref_p, np_p, x, y = model
    ref_cfg, cfg = ref_gru.gru_config(n_classes=4), gru.gru_config(
        n_classes=4)
    batch = {"frames": jnp.asarray(x), "labels": jnp.asarray(y)}

    @jax.jit
    def step(p):
        g = jax.grad(lambda q: ref_gru.train_loss(q, batch, ref_cfg))(p)
        return jax.tree.map(lambda a, b: a - 0.1 * b, p, g)

    rp = ref_p
    for _ in range(20):
        rp = step(rp)
    tp, losses = train(registry.params_from_numpy(np_p, cfg, device="cpu"),
                       torch.from_numpy(x), torch.from_numpy(y), cfg,
                       steps=20, log=lambda _: None)
    for k in tp:
        assert rel_err(np32(tp[k]), np32(rp[k])) <= SGD_TOL, k
    assert losses[-1] < losses[0] - 0.2


def test_train_under_cim_raises_naming_a10(model):
    """Training on the macro was A10's and raised until the STE wrapper was
    ported; it now runs cim_matmul_ste: the loss is the IDEAL forward's
    cross-entropy, within TOL of the reference's jax.value_and_grad, and
    every gate and head weight gets a gradient within TOL of the
    reference's (tests/test_torch_train.py holds the legs)."""
    ref_p, np_p, x, y = model
    rc, tc, _, tp = _cfgs("ideal", False, ref_p, np_p)
    batch = {"frames": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    rl, rg = jax.value_and_grad(ref_gru.train_loss)(
        ref_p, {"frames": jnp.asarray(x), "labels": jnp.asarray(y)}, rc)
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    loss = gru.train_loss(tp, batch, tc)
    loss.backward()
    assert abs(float(loss.detach()) - float(rl)) <= TOL * abs(float(rl))
    for k in ("w_z", "w_r", "w_h", "head"):
        assert float(tp[k].grad.abs().max()) > 0, k
        assert rel_err(np32(tp[k].grad), np.asarray(rg[k])) <= TOL, k


@pytest.mark.parametrize("prequant", [False, True])
def test_kws_example_runs_on_cpu(prequant, capsys):
    from repro_torch.examples import kws_gru
    kws_gru.main(["--steps", "5", "--device", "cpu"]
                 + (["--prequant"] if prequant else []))
    out = capsys.readouterr().out
    assert "fits on chip: True" in out and "float accuracy" in out
    assert out.count("FULL @") == len(kws_gru.CORNERS)
    assert ("stored codes" in out) == prequant
