"""The port's optimizers, schedule, synthetic data, int8 gradient
compression and checkpoints (`src/repro_torch/{optim, data, parallel,
checkpoint}`) against the reference package's, on the same numpy inputs.

Trees hold a layer stack: the reference keeps one stacked [L, ...] leaf per
weight name, the port a list of L per-layer dicts (the models' layout).

Tolerances (relative to the reference's largest |value|):
  * AdamW / Adafactor updates, new parameters and state over 3 steps:
    OPT_TOL 1e-6 (measured 9.6e-8 and 3.1e-7: torch's f32 pow / sqrt /
    mean and XLA:CPU's differ in the last bit);
  * the clip's norm and scaled grads (measured 0) and cosine_warmup
    (measured 3.0e-8 at peak 1, one f32 ulp of cos): 1e-6;
  * SyntheticLMDataset, synthetic_batch's stubs, compress_decompress (the
    same numpy / f32 arithmetic) and checkpoints: bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from _torch_helpers import np32, rel_err
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.checkpoint import ckpt as ref_ckpt  # noqa: E402
from repro.configs.registry import SMOKES as REF_SMOKES  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.data import tokens as ref_tokens  # noqa: E402
from repro.parallel import collectives as ref_coll  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402

OPT_TOL = 1e-6
L = 3


def _ref_tree(rng, dtype=np.float32):
    """A reference-layout tree: a stacked layer stack, a 2-D and a 1-D
    plain leaf."""
    return {"layers": {"attn": {"wq": rng.randn(L, 8, 6).astype(dtype)},
                       "norm1": {"scale": rng.randn(L, 6).astype(dtype)}},
            "tok": {"embed": rng.randn(10, 6).astype(dtype)},
            "bias": rng.randn(6).astype(dtype)}


def _port_tree(ref):
    """The same tree in the port's layout (one dict per layer)."""
    out = {"tok": {"embed": torch.from_numpy(ref["tok"]["embed"].copy())},
           "bias": torch.from_numpy(ref["bias"].copy())}
    out["layers"] = [
        {"attn": {"wq": torch.from_numpy(ref["layers"]["attn"]["wq"][i]
                                         .copy())},
         "norm1": {"scale": torch.from_numpy(
             ref["layers"]["norm1"]["scale"][i].copy())}}
        for i in range(L)]
    return out


def _stacked(port):
    """The port tree back in the reference's layout, as numpy."""
    lay = port["layers"]
    return {"layers": {"attn": {"wq": np.stack([np32(x["attn"]["wq"])
                                                for x in lay])},
                       "norm1": {"scale": np.stack(
                           [np32(x["norm1"]["scale"]) for x in lay])}},
            "tok": {"embed": np32(port["tok"]["embed"])},
            "bias": np32(port["bias"])}


def _close(port_np: dict, ref, tol):
    for a, b in zip(jax.tree.leaves(port_np), jax.tree.leaves(ref)):
        assert np.asarray(a).shape == np.asarray(b).shape
        assert rel_err(np.asarray(a, np.float32),
                       np.asarray(b, np.float32)) <= tol


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_reference(name):
    """3 updates from the same params and numpy grads: updates, params and
    state within OPT_TOL; Adafactor's stats in the reference's stacked
    layout (a layer stack's [D] norm scale factored as [L, D])."""
    rng = np.random.RandomState(0)
    ref_p = _ref_tree(rng)
    port_p = _port_tree(ref_p)
    lr = ref_optim.cosine_warmup(1e-2, 1, 10)
    plr = optim.cosine_warmup(1e-2, 1, 10)
    mk, pmk = ((ref_optim.adamw, optim.adamw) if name == "adamw"
               else (ref_optim.adafactor, optim.adafactor))
    ropt, popt = mk(lr, weight_decay=0.01), pmk(plr, weight_decay=0.01)
    rp = jax.tree.map(jnp.asarray, ref_p)
    rs, ps = ropt.init(rp), popt.init(port_p)
    pp = port_p
    for _ in range(3):
        g = _ref_tree(rng)
        ru, rs = ropt.update(jax.tree.map(jnp.asarray, g), rs, rp)
        rp = ref_optim.apply_updates(rp, ru)
        pu, ps = popt.update(_port_tree(g), ps, pp)
        pp = optim.apply_updates(pp, pu)
        _close(_stacked(pu), ru, OPT_TOL)
        _close(_stacked(pp), rp, OPT_TOL)
    assert int(ps["step"]) == int(rs["step"]) == 3
    if name == "adamw":
        _close(_stacked(ps["m"]), rs["m"], OPT_TOL)
        _close(_stacked(ps["v"]), rs["v"], OPT_TOL)
    else:
        assert tuple(ps["stats"]["layers"]["norm1"]["scale"]["vc"].shape) \
            == (6,)
        _close(jax.tree.map(np32, ps["stats"]), rs["stats"], OPT_TOL)


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros(128, 64), "s": torch.zeros(7)}
    st = optim.adafactor(lambda s: s.float() * 1e-3).init(params)
    assert st["stats"]["w"]["vr"].shape == (128,)
    assert st["stats"]["w"]["vc"].shape == (64,)
    assert st["stats"]["s"]["v"].shape == (7,)


def test_global_norm_clip_matches_reference():
    rng = np.random.RandomState(1)
    ref = _ref_tree(rng)
    port = _port_tree(ref)
    rg, rn = ref_optim.global_norm_clip(jax.tree.map(jnp.asarray, ref), 1.0)
    pg, pn = optim.global_norm_clip(port, 1.0)
    assert rel_err(np32(pn), np.asarray(rn)) <= 1e-6
    _close(_stacked(pg), rg, 1e-6)
    g = {"a": torch.full((4,), 10.0)}
    clipped, gn = optim.global_norm_clip(g, 1.0)
    assert float(gn) == 20.0
    np.testing.assert_allclose(clipped["a"].numpy(), 0.5, rtol=1e-6)


def test_cosine_warmup_matches_reference():
    r, p = ref_optim.cosine_warmup(1.0, 10, 100), optim.cosine_warmup(
        1.0, 10, 100)
    for s in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        a = float(p(torch.tensor(s, dtype=torch.int32)))
        b = float(r(jnp.asarray(s, jnp.int32)))
        assert abs(a - b) <= 1e-6 * max(abs(b), 1e-6), (s, a, b)
    assert float(p(torch.tensor(0))) == 0.0
    assert float(p(torch.tensor(10))) == 1.0


@pytest.mark.parametrize("kw", [dict(seed=3), dict(seed=0, n_hosts=2,
                                                   host_id=1)])
def test_synthetic_batches_bit_exact(kw):
    for step in (0, 5):
        a = tokens.SyntheticLMDataset(512, 32, 8, **kw).batch(step)
        b = ref_tokens.SyntheticLMDataset(512, 32, 8, **kw).batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "internvl2-26b",
                                  "whisper-large-v3"])
def test_synthetic_batch_stubs_bit_exact(arch):
    shape = (ShapeConfig("t", 24, 2, "train"), RefShape("t", 24, 2, "train"))
    a = tokens.synthetic_batch(SMOKES[arch], shape[0], step=2, seed=1,
                               device="cpu")
    b = ref_tokens.synthetic_batch(REF_SMOKES[arch], shape[1], step=2, seed=1)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == (torch.bfloat16 if b[k].dtype == jnp.bfloat16
                              else torch.int32)
        np.testing.assert_array_equal(np32(a[k]),
                                      np.asarray(b[k], np.float32))


def test_compress_decompress_bit_exact():
    rng = np.random.RandomState(2)
    x = rng.randn(64, 33).astype(np.float32)
    err = (rng.randn(64, 33) * 1e-3).astype(np.float32)
    y, e = collectives.compress_decompress(torch.from_numpy(x),
                                           torch.from_numpy(err))
    ry, re_ = ref_coll.compress_decompress(jnp.asarray(x), jnp.asarray(err))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    np.testing.assert_array_equal(e.numpy(), np.asarray(re_))
    q, s = collectives.quantize_int8(torch.from_numpy(x))
    rq, rs = ref_coll.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    # bf16 in, bf16 out, f32 residue
    yb, eb = collectives.compress_decompress(
        torch.from_numpy(x).bfloat16(), torch.zeros(64, 33))
    assert yb.dtype == torch.bfloat16 and eb.dtype == torch.float32


def _state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"a": torch.randn(8, 16, generator=g),
                       "layers": [{"w": torch.randn(4, generator=g)
                                   .bfloat16()} for _ in range(2)]},
            "opt": {"step": torch.tensor(3, dtype=torch.int32)}}


def test_checkpoint_roundtrip_including_bf16(tmp_path):
    t = _state()
    ckpt.save_pytree(str(tmp_path / "ck"), t, metadata={"step": 7})
    out, md = ckpt.load_pytree(str(tmp_path / "ck"), t, device="cpu")
    assert md["step"] == 7
    for a, b in zip(optim.optimizers.tree_leaves(t),
                    optim.optimizers.tree_leaves(out)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    with open(tmp_path / "ck" / "index.json") as f:
        assert "['params']['layers'][1]['w']" in f.read()
    with pytest.raises(ValueError):
        ckpt.load_pytree(str(tmp_path / "ck"),
                         {"params": {"a": torch.zeros(8, 15)}})
    with pytest.raises(KeyError):
        ckpt.load_pytree(str(tmp_path / "ck"), {"nope": torch.zeros(1)})


def test_checkpoint_format_reads_in_the_reference(tmp_path):
    """A port checkpoint of a plain tree is the reference's format: the
    reference's load_pytree reads it back, bf16 included."""
    t = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "b": {"c": torch.tensor([1.5, -2.25]).bfloat16()}}
    ckpt.save_pytree(str(tmp_path / "ck"), t)
    like = {"a": jax.ShapeDtypeStruct((2, 3), jnp.float32),
            "b": {"c": jax.ShapeDtypeStruct((2,), jnp.bfloat16)}}
    out, _ = ref_ckpt.load_pytree(str(tmp_path / "ck"), like)
    np.testing.assert_array_equal(np.asarray(out["a"]), t["a"].numpy())
    np.testing.assert_array_equal(np.asarray(out["b"]["c"], np.float32),
                                  [1.5, -2.25])


def test_keep_n_retention_and_restore_latest(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30, 40):
        t = _state()
        t["params"]["a"] += s
        mgr.save(s, t)
    assert mgr.steps() == [30, 40] and mgr.latest_step() == 40
    out, md = mgr.restore(_state())
    assert md["step"] == 40
    assert torch.equal(out["params"]["a"], _state()["params"]["a"] + 40)


def test_atomic_overwrite(tmp_path):
    p = str(tmp_path / "ck")
    ckpt.save_pytree(p, {"a": torch.ones(2)})
    ckpt.save_pytree(p, {"a": torch.zeros(2)})
    out, _ = ckpt.load_pytree(p, {"a": torch.empty(2)})
    assert float(out["a"].sum()) == 0.0
    assert not [d for d in os.listdir(tmp_path) if ".tmp" in d]
