"""Training of the recurrent archs in the port (ROADMAP A10b) against the
reference package: rwkv6-7b (the chunked WKV6 scan under autograd) and
zamba2-2.7b (mamba2's chunked SSD, the causal conv, the weight-shared
attention block): `train_loss` and every gradient at --cim off and bp;
and reference checkpoints of these archs and of whisper-large-v3 and
internvl2-26b read into the port's state and resumed in its Trainer.
whisper's and internvl2's losses (the prefixed transformers) are
test_torch_train_prefix.py: the two files are split to keep each near a
minute in one process (the reference runs op by op).

Weights come from a reference init carried across by `params_from_numpy`,
inputs from numpy seeds; the reference runs op by op (layers unrolled, no
remat, no jit) and is differentiated with jax.value_and_grad.

Tolerances (measured):
  * train_loss: LOSS_TOL 1e-6 relative (measured ≤ 2.2e-7: torch's f32
    exp / rsqrt and its sum orders differ from XLA:CPU's in the last bit;
    under CIM no DAC code moved at these inputs); per-layer remat on vs
    off bit for bit;
  * every gradient relative to its reference's largest |value|, or to
    GRAD_FLOOR 1e-5 of the whole tree's largest where that is larger
    (`compare_grads`): zamba2's a_log / dt_bias gradients are ~1e-6 of the
    tree's scale, sums with heavy cancellation.
    RECURRENT_GRAD_TOL 5e-5 for rwkv6 and zamba2 (measured 2.3e-5 on
    rwkv6's decay_w0 and 3.5e-5 on zamba2's SSD leaves: the chunked scans
    carry last-bit differences through every chunk, ROADMAP Queue C);
  * the chunked WKV6 scan's gradients: GRAD_TOL 1e-5 (measured 2.2e-7);
    the chunked SSD's where its decays overflow, x / B / C: GRAD_TOL;
  * a reference checkpoint read into the port's state: bit for bit.
"""
import numpy as np
import pytest
import torch

from _torch_helpers import (check_train_loss, compare_grads, rel_err,
                            to_numpy_tree)
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.ckpt import CheckpointManager as RefManager  # noqa
from repro.configs.registry import SMOKES as REF_SMOKES  # noqa: E402
from repro.data.tokens import SyntheticLMDataset  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models import rwkv6 as ref_rwkv6  # noqa: E402
from repro.optim import optimizers as ref_optim  # noqa: E402
from repro_torch.checkpoint.ckpt import load_numpy_tree  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.models import registry, rwkv6  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.runtime.trainer import Trainer, make_optimizer  # noqa

LOSS_TOL = 1e-6
RECURRENT_GRAD_TOL = 5e-5
GRAD_FLOOR = 1e-5
GRAD_TOL = 1e-5
SEQ, BATCH = 16, 2
ARCHS = ("rwkv6-7b", "zamba2-2.7b")


@pytest.fixture(scope="module")
def ref_weights():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = REF_SMOKES[arch].replace(dtype="float32")
            cache[arch] = ref_registry.init_params(jax.random.PRNGKey(0), cfg,
                                                   max_seq=SEQ + 8)
        return cache[arch]
    return get


def _batch(arch: str) -> dict:
    return SyntheticLMDataset(SMOKES[arch].vocab, SEQ, BATCH, seed=0).batch(0)


@pytest.mark.parametrize("leg", ["off", "bp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_reference(ref_weights, arch, leg):
    """The float32 smoke model's loss and every gradient (zamba2's shared
    block summed over its applications) against jax.value_and_grad of the
    reference's train_loss; per-layer remat on vs off bit for bit."""
    _, grads, _ = check_train_loss(
        ref_weights(arch), arch, leg, _batch(arch), loss_tol=LOSS_TOL,
        grad_tol=RECURRENT_GRAD_TOL, floor=GRAD_FLOOR)
    if SMOKES[arch].ssm.shared_every:
        assert float(grads["shared"]["attn"]["wq"].abs().max()) > 0


def test_wkv6_chunked_gradients_match_jax_grad():
    """The chunked WKV6 scan under autograd, T not a multiple of the chunk
    (the −1e-4 log-decay padding), from a carried state: gradients of
    Σ c·y + Σ d·S with respect to r, k, v, the log-decays, u and S₀."""
    rng = np.random.RandomState(9)
    b, t, h, dh, chunk = 2, 21, 2, 8, 8
    r, k, v = (rng.randn(b, t, h, dh).astype(np.float32) for _ in range(3))
    lw = -np.exp(rng.uniform(-4, 1.5, (b, t, h, dh))).clip(
        0, 5).astype(np.float32) - 1e-4
    u = rng.randn(h, dh).astype(np.float32)
    s0 = rng.randn(b, h, dh, dh).astype(np.float32)
    cy = rng.randn(b, t, h, dh).astype(np.float32)
    cs = rng.randn(b, h, dh, dh).astype(np.float32)

    def ref_f(*a):
        y, s = ref_rwkv6.wkv6_chunked(*a[:5], chunk=chunk, state0=a[5],
                                      unroll=True)
        return jnp.sum(y * cy) + jnp.sum(s * cs)

    rg = jax.grad(ref_f, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (r, k, v, lw, u, s0)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (r, k, v, lw, u, s0)]
    y, s = rwkv6.wkv6_chunked(*ts[:5], chunk=chunk, state0=ts[5])
    loss = (y * torch.from_numpy(cy)).sum() + (s * torch.from_numpy(cs)).sum()
    grads = torch.autograd.grad(loss, ts)
    assert compare_grads({str(i): g for i, g in enumerate(grads)},
                         {str(i): np.asarray(a) for i, a in enumerate(rg)}) \
        <= GRAD_TOL


def test_ssd_chunked_gradients_stay_finite_where_decays_overflow():
    """A chunk whose decays add past ~88 (large a·dt over 64 steps):
    exp(l_i − l_j) above the diagonal overflows. The forward matches the
    reference's (torch's exp differs from XLA's in the last bit); the
    reference's dt gradient is NaN (it masks after the exp: 0 · inf), the
    port's is finite, and the gradients the reference gets finite (x, B,
    C) match; all within GRAD_TOL."""
    from repro.models import mamba2 as ref_mamba2
    from repro_torch.models import mamba2
    rng = np.random.RandomState(0)
    b, t, h, dh, n, chunk = 1, 64, 2, 4, 8, 64
    xh = rng.randn(b, t, h, dh).astype(np.float32)
    dt = (np.abs(rng.randn(b, t, h)) * 0.5 + 0.3).astype(np.float32)
    a = np.array([-4.0, -16.0], np.float32)
    bm, cm_ = (rng.randn(b, t, n).astype(np.float32) for _ in range(2))

    def ref_f(xx, dd, bb, cc):
        y, s = ref_mamba2.ssd_chunked(xx, dd, jnp.asarray(a), bb, cc,
                                      chunk=chunk, unroll=True)
        return jnp.sum(y) + jnp.sum(s), (y, s)

    (_, (ry, rs)), rg = jax.value_and_grad(ref_f, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        *(jnp.asarray(v) for v in (xh, dt, bm, cm_)))
    assert not np.isfinite(np.asarray(rg[1])).all()
    ts = [torch.from_numpy(v).requires_grad_() for v in (xh, dt, bm, cm_)]
    y, s = mamba2.ssd_chunked(ts[0], ts[1], torch.from_numpy(a), ts[2],
                              ts[3], chunk=chunk)
    assert rel_err(y.detach().numpy(), np.asarray(ry)) <= GRAD_TOL
    assert rel_err(s.detach().numpy(), np.asarray(rs)) <= GRAD_TOL
    grads = torch.autograd.grad(y.sum() + s.sum(), ts)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert compare_grads({"x": grads[0], "b": grads[2], "c": grads[3]},
                         {"x": np.asarray(rg[0]), "b": np.asarray(rg[2]),
                          "c": np.asarray(rg[3])}) <= GRAD_TOL


def test_unused_shared_block_gets_zero_gradients():
    """zamba2 cut below shared_every layers never applies its shared
    block: the train step gives it zero gradients, as jax.grad does, and
    runs."""
    from repro_torch.runtime.trainer import make_train_step, value_and_grad
    cfg = SMOKES["zamba2-2.7b"].replace(n_layers=2)
    params = registry.init_params(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch("zamba2-2.7b").items()}
    _, grads = value_and_grad(
        lambda p, bb: registry.train_loss(p, bb, cfg), params, batch)
    assert not any(bool(g.any()) for g in tree_leaves(grads["shared"]))
    assert float(grads["layers"][0]["ssm"]["w_in"].abs().max()) > 0
    step, opt = make_train_step(cfg, TrainConfig(steps=4))
    _, m = step({"params": params, "opt": opt.init(params)}, batch)
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("arch,opt", [("rwkv6-7b", "adamw"),
                                      ("zamba2-2.7b", "adafactor"),
                                      ("whisper-large-v3", "adamw"),
                                      ("internvl2-26b", "adafactor")])
def test_reference_checkpoint_is_the_port_state(tmp_path, ref_weights, arch,
                                                opt):
    """A trainer state written by the reference's CheckpointManager
    (params, and AdamW's m / v or Adafactor's stacked factored statistics,
    filled with numpy draws so every leaf is told apart) reads into the
    port's state leaf for leaf, in the layout the port's optimizer keeps,
    and the port's Trainer resumes from it (whisper has no Trainer in
    either package: its batches need frames)."""
    cfg = SMOKES[arch].replace(dtype="float32")
    rp = ref_weights(arch)
    ref_opt = (ref_optim.adafactor if opt == "adafactor"
               else ref_optim.adamw)(lambda s: 1e-3)
    rng = np.random.RandomState(5)
    ost = jax.tree.map(lambda a: jnp.asarray(
        rng.rand(*a.shape).astype(np.float32)) if a.ndim else a,
        ref_opt.init(rp))
    mgr = RefManager(str(tmp_path / "ref"))
    mgr.save(2, {"params": rp, "opt": ost})
    tree, _ = load_numpy_tree(mgr._step_dir(2))
    state = registry.state_from_numpy(tree, cfg, device="cpu")
    port_opt = make_optimizer(TrainConfig(optimizer=opt)).init(
        state["params"])
    want = to_numpy_tree({"params": rp, "opt": ost})
    for name in ("params", "opt"):
        assert compare_grads(state[name], want[name], zero=()) == 0.0, name
    assert [t.shape for t in tree_leaves(port_opt)] \
        == [t.shape for t in tree_leaves(state["opt"])]
    if arch == "whisper-large-v3":
        return
    tr = Trainer(cfg, ShapeConfig("tiny", SEQ, BATCH, "train"),
                 TrainConfig(steps=3, optimizer=opt, checkpoint_every=4),
                 str(tmp_path / "ref"), device="cpu")
    out = tr.run()
    assert [m["step"] for m in out["metrics"]] == [2]
    assert np.isfinite(out["metrics"][0]["loss"])
