"""parallel.collectives.compressed_psum, parallel.pipeline and
models.common.dense_rs of the port against the reference
(tests/test_collectives.py, test_pipeline.py, test_dense_rs.py).

In process (one rank): compressed_psum against the reference's on its
1-device mesh, bit for bit; a single-stage pipeline is the identity
schedule. Two ranks (one spawn of 2 gloo processes): compressed_psum
against its formula over both ranks' inputs; a 2-stage pipeline equal to
the stages applied in sequence; the smoke llama3-8b's prefill at --cim
off with dense_rs (tp_reduce_scatter) on a 1 x 2 (data, model) mesh
against no mesh within 1e-5 (the split contraction sums in another
order), the mesh alone changing nothing at --cim off, and finite
gradients through the reduce-scatter.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_helpers import one_intra_op_thread, spawn_ranks  # noqa: F401

from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.parallel import sharding as ref_sharding
from repro.parallel.collectives import compressed_psum as ref_psum
from repro_torch.configs.registry import SMOKES
from repro_torch.core.cim_matmul import CIMConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import common
from repro_torch.parallel import sharding
from repro_torch.parallel.collectives import compressed_psum
from repro_torch.parallel.pipeline import pipeline_apply


@pytest.fixture
def one_rank():
    """The default process group of one gloo rank, destroyed after."""
    owned = not dist.is_initialized()
    yield
    if owned and dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return spawn_ranks("parallel", 2, tmp_path_factory.mktemp("parallel"))


def test_compressed_psum_one_rank_vs_reference(one_rank):
    """Mean-psum of one participant, as the reference's test_collectives
    runs it on a 1-device mesh: the same result and residue, bit for bit,
    and y + err reconstructs x."""
    mesh = ref_make_mesh((1,), ("data",))
    x = np.linspace(-1, 1, 64).astype(np.float32)
    err0 = (np.random.RandomState(2).standard_normal(64) * 1e-3).astype(
        np.float32)
    ref_y, ref_err = jax.jit(ref_sharding.shard_map(
        lambda a, e: ref_psum(a, "data", e), mesh=mesh,
        in_specs=(jax.sharding.PartitionSpec(),) * 2,
        out_specs=(jax.sharding.PartitionSpec(),) * 2))(
            jnp.asarray(x), jnp.asarray(err0))
    world = make_mesh((1,), ("data",), device="cpu").get_group("data")
    y, err = compressed_psum(torch.from_numpy(x), world,
                             torch.from_numpy(err0))
    assert np.array_equal(y.numpy(), np.asarray(ref_y))
    assert np.array_equal(err.numpy(), np.asarray(ref_err))
    np.testing.assert_allclose((y + err).numpy(), x + err0, atol=1e-6)


def test_compressed_psum_two_ranks_formula(two_ranks):
    """Both ranks get the int32 sum of their int8 codes on the shared
    scale (max over ranks of max|x + err| / 127), times the scale, over
    2; each keeps its own residue, x + err − q · scale rounded once."""
    xf = [torch.from_numpy(o["psum_x"]) + torch.from_numpy(o["psum_err"])
          for o in two_ranks]
    scale = torch.clamp(torch.max(torch.stack([t.abs().max() for t in xf]))
                        / torch.full((), 127.0), min=1e-12)
    q = [torch.clamp(torch.round(t / scale), -127, 127) for t in xf]
    want = (q[0].to(torch.int32) + q[1].to(torch.int32)).float() * scale / 2
    for o, t, qq in zip(two_ranks, xf, q):
        assert np.array_equal(o["psum_y"], want.numpy())
        # the residue rounded once (exact in float64, then to f32)
        resid = t.double() - qq.double() * scale.double()
        assert np.array_equal(o["psum_new_err"], resid.float().numpy())


def test_single_stage_pipeline_is_identity_schedule(one_rank):
    mesh = make_mesh((1,), ("stage",), device="cpu")
    w = torch.tensor([[2.0]])

    def stage(params, h):
        return h * params[0, 0]

    x = torch.arange(6.0).reshape(3, 2)[:, None, :]   # 3 microbatches
    out = pipeline_apply(stage, w[None], x, mesh=mesh)
    assert torch.equal(out, x * 2.0)


def test_two_stage_pipeline_equals_stages_in_sequence(two_ranks):
    for o in two_ranks:
        assert np.array_equal(o["pipe"], o["pipe_seq"])


def test_dense_rs_matches_no_mesh(two_ranks):
    for o in two_ranks:
        np.testing.assert_allclose(o["logits_rs"], o["logits_plain"],
                                   rtol=1e-5, atol=1e-5)
        assert np.array_equal(o["logits_mesh"], o["logits_plain"])
        assert np.all(o["rs_grads"] == 1.0)       # present and finite
    assert np.array_equal(two_ranks[0]["logits_rs"],
                          two_ranks[1]["logits_rs"])


def test_rs_applicable_conditions(monkeypatch):
    """dense_rs needs tp_reduce_scatter, CIM off and a mesh whose "model"
    axis divides T and the input width and whose batch axes divide B."""
    cfg = SMOKES["llama3-8b"].replace(tp_reduce_scatter=True)
    x = torch.zeros((4, 16, 64))
    assert not common._rs_applicable(cfg, x)                 # no mesh
    monkeypatch.setattr(sharding, "_MESH", types.SimpleNamespace(
        axis_names=("data", "model"), shape={"data": 2, "model": 4}))
    assert common._rs_applicable(cfg, x)
    assert not common._rs_applicable(cfg.replace(tp_reduce_scatter=False),
                                     x)
    assert not common._rs_applicable(
        cfg.replace(cim=CIMConfig(enabled=True)), x)
    assert not common._rs_applicable(cfg, torch.zeros((4, 15, 64)))
    assert not common._rs_applicable(cfg, torch.zeros((3, 16, 64)))
    assert not common._rs_applicable(cfg, torch.zeros((16, 64)))
