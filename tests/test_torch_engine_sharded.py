"""The port's mesh-sharded CIM dispatch against the reference's
(tests/test_engine_sharded.py, test for test).

In process: a 1-rank gloo mesh is bit-identical to no mesh (IDEAL and
NOISY, dense and packed codes; the salt is 0); choose_backend is
mesh-independent; mvm_plan's axis assignment; the per-shard region flag;
the salt contract. Four ranks: one spawn of 4 gloo processes on a 2 x 2
(data, model) mesh against one reference subprocess with 4 forced host
devices on make_host_mesh(2, 2), on the same numpy inputs (x [8, 576],
w [576, 64]): IDEAL and NOISY outputs bit-exact (K = 576 splits into two
288-row shards, so the sum of two partials is order-free), packed equal
to unpacked, duplicated columns drawing different noise (the seed salted
by the shard index), the gradients of x and of the weights close to no
mesh's, and dense_rs's logits and gradients on the same mesh close to no
mesh's.
"""
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_helpers import one_intra_op_thread, spawn_ranks  # noqa: F401

from repro_torch.core.cim_matmul import (CIMConfig, cim_matmul,
                                         cim_matmul_prequant,
                                         quantize_weight_offline)
from repro_torch.core.engine import choose_backend
from repro_torch.core.macro import SimLevel
from repro_torch.kernels.ops import pack_codes, salt_seed
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel import sharding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _noisy_cfg(seed=0, backend="auto"):
    return CIMConfig(enabled=True, backend=backend, noise_seed=seed,
                     macro=dataclasses.replace(CIMConfig().macro,
                                               sim_level=SimLevel.NOISY))


def _xw(seed, m=8, k=576, n=64):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


@pytest.fixture
def mesh1():
    owned = not dist.is_initialized()
    mesh = make_host_mesh(1, 1, device="cpu")
    sharding.set_mesh(mesh)
    yield mesh
    sharding.set_mesh(None)
    if owned:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# in process: one rank
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("container", ["float", "dense", "packed"])
def test_one_rank_mesh_bit_identical_noisy(mesh1, container):
    """A 1-rank mesh's shard is the whole MVM, its salt 0: bit-identical
    to the call without a mesh."""
    _check_one_rank(mesh1, _noisy_cfg(seed=3), container, 0)


@pytest.mark.parametrize("container", ["float", "dense", "packed"])
def test_one_rank_mesh_bit_identical_ideal(mesh1, container):
    _check_one_rank(mesh1, CIMConfig(enabled=True), container, 1)


def _check_one_rank(mesh, cfg, container, seed):
    x, w = _xw(seed)
    if container == "float":
        def call():
            return cim_matmul(x, w, cfg)
    else:
        codes, s_w = quantize_weight_offline(w, cfg)
        wc = pack_codes(codes) if container == "packed" else codes

        def call():
            return cim_matmul_prequant(x, wc, s_w, cfg)
    y_mesh = call()
    sharding.set_mesh(None)
    y_plain = call()
    sharding.set_mesh(mesh)
    assert torch.equal(y_mesh, y_plain)


def test_auto_still_resolves_fused_under_mesh(monkeypatch):
    """The backend choice is mesh-independent: NOISY with a seed picks the
    fused stochastic kernel under a mesh too (the engine partitions it)."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 16, "model": 16})
    monkeypatch.setattr(sharding, "_MESH", mesh)
    x, w = torch.zeros((4, 576)), torch.zeros((576, 64))
    assert choose_backend(_noisy_cfg(seed=0), x, w) == "cuda_noisy"
    assert choose_backend(CIMConfig(enabled=True), x, w) == "cuda"


def test_mvm_plan_axis_assignment(monkeypatch):
    mesh = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                 shape={"pod": 2, "data": 16, "model": 16})
    monkeypatch.setattr(sharding, "_MESH", mesh)
    plan = sharding.mvm_plan((128, 1, 2304), 2304, 2048)
    assert plan.ctr_axes == ("data",)
    assert plan.col_axes == ("model",)
    assert plan.row_axes == ("pod",)
    assert plan.axes == ("pod", "data", "model")
    plan = sharding.mvm_plan((128, 1, 2300), 2300, 2048)
    assert plan.ctr_axes == ()
    assert plan.row_axes == ("pod", "data")
    plan = sharding.mvm_plan((8, 2288), 2288, 64, k_unit=2)
    assert plan.ctr_axes == ()   # 2288 % (16 * 2) = 16 → replicate
    plan = sharding.mvm_plan((8, 2304), 2304, 64, k_unit=2)
    assert plan.ctr_axes == ("data",)
    monkeypatch.setattr(sharding, "_MESH", None)
    plan = sharding.mvm_plan((8, 2304), 2304, 64)
    assert plan.ctr_axes == plan.row_axes == plan.col_axes == ()


def test_in_shard_context_flag(mesh1):
    """shard_context marks per-shard code (the engine's nesting guard):
    an MVM inside it runs on its operands as they are, unpartitioned."""
    seen = []
    assert not sharding.in_shard_context()
    with sharding.shard_context():
        seen.append(sharding.in_shard_context())
        x, w = _xw(2)
        y_in = cim_matmul(x, w, CIMConfig(enabled=True))
    assert seen == [True]
    assert not sharding.in_shard_context()
    assert torch.equal(y_in, cim_matmul(x, w, CIMConfig(enabled=True)))


def test_salt_seed_contract():
    """salt 0 = identity; distinct salts give distinct streams; the
    golden-ratio scramble bit for bit: seed ^ (salt * 0x9E3779B9 mod
    2^32)."""
    assert int(salt_seed(1234, 0)) == 1234
    a, b = int(salt_seed(1234, 1)), int(salt_seed(1234, 2))
    assert len({1234, a, b}) == 3
    assert int(salt_seed(torch.tensor(1234, dtype=torch.int32), 7)) == \
        int(salt_seed(1234, 7))
    expect = np.uint32(1234) ^ np.uint32((7 * 0x9E3779B9) & 0xFFFFFFFF)
    assert np.uint32(int(salt_seed(1234, 7)) & 0xFFFFFFFF) == expect


# ---------------------------------------------------------------------------
# four ranks against the reference's four forced host devices
# ---------------------------------------------------------------------------
REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("REPRO_FORCE_JNP", None)
import dataclasses
import jax.numpy as jnp, numpy as np
from repro.core.cim_matmul import (CIMConfig, cim_matmul,
                                   cim_matmul_prequant,
                                   quantize_weight_offline)
from repro.core.macro import SimLevel
from repro.kernels.ops import pack_codes
from repro.launch.mesh import make_host_mesh
from repro.parallel import sharding

noisy = CIMConfig(enabled=True, noise_seed=3,
                  macro=dataclasses.replace(CIMConfig().macro,
                                            sim_level=SimLevel.NOISY))
ideal = CIMConfig(enabled=True)
rng = np.random.RandomState(0)
x = jnp.asarray(rng.standard_normal((8, 576)).astype(np.float32))
w = jnp.asarray((rng.standard_normal((576, 64)) * 0.1).astype(np.float32))
sharding.set_mesh(make_host_mesh(2, 2))
out = {"ideal": cim_matmul(x, w, ideal), "noisy": cim_matmul(x, w, noisy),
       "dup": cim_matmul(x, jnp.concatenate([w, w], axis=1), noisy)}
for tag, cfg in (("ideal", ideal), ("noisy", noisy)):
    codes, s_w = quantize_weight_offline(w, cfg)
    out[tag + "_u"] = cim_matmul_prequant(x, codes, s_w, cfg)
    out[tag + "_p"] = cim_matmul_prequant(x, pack_codes(codes), s_w, cfg)
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """(the reference's outputs, the port's per-rank outputs): the
    reference subprocess runs while the port's four ranks do."""
    where = tmp_path_factory.mktemp("engine4")
    ref_path = str(where / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, ref_path],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        port = spawn_ranks("engine", 4, where)
        log = ref.communicate(timeout=600)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log[-3000:]
    with np.load(ref_path) as z:
        return {k: z[k] for k in z.files}, port


@pytest.mark.parametrize("name", ["ideal", "noisy", "dup", "ideal_u",
                                  "ideal_p", "noisy_u", "noisy_p"])
def test_four_ranks_bit_exact_vs_reference(four_ranks, name):
    ref, port = four_ranks
    for rank, out in enumerate(port):
        assert np.array_equal(out[name], ref[name]), (name, rank)


def test_four_ranks_packed_equals_unpacked_and_reproducible(four_ranks):
    _, port = four_ranks
    out = port[0]
    assert np.array_equal(out["noisy_p"], out["noisy_u"])
    assert np.array_equal(out["ideal_p"], out["ideal_u"])
    assert np.array_equal(out["noisy"], out["noisy_again"])


def test_four_ranks_duplicated_columns_draw_different_noise(four_ranks):
    """The two model shards of [w, w] solve identical local problems at
    identical local coordinates: only the salt tells their draws apart."""
    _, port = four_ranks
    dup = port[0]["dup"]
    assert (dup[:, :64] != dup[:, 64:]).any()


@pytest.mark.parametrize("name", ["grad", "wgrad"])
def test_four_ranks_gradients(four_ranks, name):
    """Gradients of x and of the float weights flow through the sharded
    dispatch (the einsum VJP per shard, the placement ops' backward; w is
    sliced over "data" and "model" at once): finite, equal on every rank,
    and within float reassociation of no mesh's (2e-5 of the largest)."""
    _, port = four_ranks
    g, g0 = port[0][name + "_mesh"], port[0][name + "_nomesh"]
    assert np.isfinite(g).all()
    assert all(np.array_equal(out[name + "_mesh"], g) for out in port)
    assert np.max(np.abs(g - g0)) <= 2e-5 * np.max(np.abs(g0))


def test_four_ranks_dense_rs_gradients(four_ranks):
    """dense_rs on the 2 x 2 mesh (x sliced over the batch and "model" at
    once, the reduce-scatter over "model"): the smoke llama3-8b's prefill
    logits and the first layer's gradients within float reassociation of
    no mesh's (2e-5 of the largest), equal on every rank."""
    _, port = four_ranks
    for name in ("rs_logits", "rs_grads"):
        g, g0 = port[0][name + "_mesh"], port[0][name + "_nomesh"]
        assert np.isfinite(g).all(), name
        assert all(np.array_equal(out[name + "_mesh"], g) for out in port)
        assert np.max(np.abs(g - g0)) <= 2e-5 * np.max(np.abs(g0)), name
