"""parallel.sharding of the port against the reference's
(tests/test_sharding.py, test for test): the divisibility fallback, the
logical axes, the parameter rules and optimizer-state inheritance; then
axes_for / tree_param_specs leaf for leaf against the reference's on the
smoke params of every arch, and mvm_plan against the reference's on a
grid of shapes and meshes. Pure rules: the meshes are process-free
stand-ins (axis names and sizes), as the reference tests' fake mesh."""
import types

import jax
import pytest
import torch

from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

from repro.configs.registry import SMOKES as REF_SMOKES
from repro.models import registry as ref_registry
from repro.parallel import sharding as ref_sharding
from repro_torch.configs.registry import SMOKES
from repro_torch.models import registry
from repro_torch.parallel import sharding

MESHES = [{"pod": 2, "data": 16, "model": 16}, {"data": 16, "model": 16},
          {"data": 2, "model": 2}, {"data": 4, "model": 1},
          {"data": 1, "model": 4}, {"data": 3, "model": 2}]


def _fake(shape: dict):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


@pytest.fixture
def fake_mesh(monkeypatch):
    mesh = _fake({"pod": 2, "data": 16, "model": 16})
    monkeypatch.setattr(sharding, "_MESH", mesh)
    return mesh


@pytest.fixture
def both_meshes(monkeypatch):
    """Install one stand-in mesh in both packages (and FSDP on both)."""
    def install(shape, fsdp=True):
        monkeypatch.setattr(sharding, "_MESH", _fake(shape))
        monkeypatch.setattr(ref_sharding, "_MESH", _fake(shape))
        monkeypatch.setattr(sharding, "_FSDP", fsdp)
        monkeypatch.setattr(ref_sharding, "_FSDP", fsdp)
    return install


def test_spec_divisible(fake_mesh):
    assert sharding.spec_for((4096, 14336), ("fsdp", "tp")) == \
        ("data", "model")


def test_spec_drops_nondivisible(fake_mesh):
    # 8 kv heads on a 16-way model axis → replicate (Megatron fallback)
    assert sharding.spec_for((4096, 8), ("fsdp", "tp")) == ("data", None)


def test_batch_resolves_to_pod_and_data(fake_mesh):
    assert sharding.spec_for((256, 4096), ("batch", None)) == \
        (("pod", "data"), None)
    # batch=1 cannot shard 32 ways → dropped
    assert sharding.spec_for((1, 4096), ("batch", None)) == (None, None)


def test_seq_axis_combines_data_and_model(fake_mesh):
    assert sharding.spec_for((1, 524288), (None, "seq")) == \
        (None, ("data", "model"))


def test_param_rules_attention(fake_mesh):
    assert sharding.axes_for(("layers", "attn", "wq"), 3) == (None, "fsdp",
                                                              "tp")
    assert sharding.axes_for(("tok", "embed"), 2) == ("tp", "fsdp")
    # the port's layers are a list: a per-layer leaf has no stacked dim
    assert sharding.axes_for(("layers", 3, "attn", "wq"), 2) == ("fsdp",
                                                                 "tp")


def test_adafactor_stats_inherit_param_rules(fake_mesh):
    assert sharding.axes_for(("stats", "layers", "ffn", "e_gate", "vr"),
                             3) == (None, "expert", "fsdp")
    assert sharding.axes_for(("stats", "layers", "ffn", "e_gate", "vc"),
                             3) == (None, "expert", None)


def test_adamw_state_uses_param_name(fake_mesh):
    assert sharding.axes_for(("m", "layers", "ffn", "w_up"), 3) == (
        None, "fsdp", "tp")


def test_no_mesh_means_no_constraints():
    sharding.set_mesh(None)
    x = torch.ones((4, 4))
    assert sharding.constrain(x, "batch", None) is x
    assert sharding.spec_for((4, 4), ("batch", "tp")) == (None, None)
    assert sharding.mvm_plan((4, 4), 4, 4) == sharding.MVMPlan()


# ---------------------------------------------------------------------------
# leaf for leaf against the reference
# ---------------------------------------------------------------------------
def _ref_specs(arch):
    """{path: spec tuple} of the reference's smoke params (shapes only)."""
    shapes = jax.eval_shape(lambda: ref_registry.init_params(
        jax.random.PRNGKey(0), REF_SMOKES[arch], max_seq=64))
    specs = ref_sharding.tree_param_specs(shapes)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return {tuple(k.key for k in kp): tuple(s) for kp, s in flat[0]}


@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_tree_param_specs_leaf_for_leaf(arch, both_meshes):
    """The port's specs of its smoke params equal the reference's, leaf
    for leaf, on every mesh; a layer of a port layer list against the
    reference's stacked leaf less its L entry; and axes_for equals the
    reference's on the reference's own paths."""
    params = registry.init_params(SMOKES[arch], seed=0, device="cpu",
                                  max_seq=64)
    for shape in MESHES:
        for fsdp in (True, False):
            both_meshes(shape, fsdp)
            ref = _ref_specs(arch)
            got = dict(_walk_specs(sharding.tree_param_specs(params)))
            seen = set()
            for path, spec in got.items():
                key = tuple(k for k in path if not isinstance(k, int))
                want = ref[key]
                if len(key) != len(path):          # a layer of a list
                    want = want[1:]
                assert spec == want, (arch, shape, path)
                seen.add(key)
            assert seen == set(ref), set(ref) ^ seen
            for path in ref:
                for ndim in (1, 2, 3, 4):
                    assert sharding.axes_for(path, ndim) == \
                        ref_sharding.axes_for(path, ndim), (path, ndim)


def _walk_specs(tree, prefix=()):
    """(path, spec) over a tree of dicts and lists whose leaves are spec
    tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk_specs(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk_specs(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
def test_mvm_plan_equals_reference(shape, both_meshes):
    both_meshes(shape)
    for x_shape in ((128, 1, 2304), (128, 1, 2300), (8, 2288), (8, 2304),
                    (1, 4096), (6, 576), (32, 64, 1152), (2304,)):
        k = x_shape[-1]
        for m in (2048, 64, 96, 100, 92544):
            for k_unit in (1, 2):
                ref = ref_sharding.mvm_plan(x_shape, k, m, k_unit=k_unit)
                got = sharding.mvm_plan(x_shape, k, m, k_unit=k_unit)
                assert (got.ctr_axes, got.row_axes, got.col_axes) == \
                    (ref.ctr_axes, ref.row_axes, ref.col_axes)
                nd = len(x_shape)
                assert got.x_spec(nd) == tuple(ref.x_spec(nd))
                assert got.w_spec() == tuple(ref.w_spec())
                assert got.out_spec(nd) == tuple(ref.out_spec(nd))
