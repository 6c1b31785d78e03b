"""The paged attention's KV-head split over "model" (the reference's
`kernels/paged_attention._mesh_attn_specs` mesh dispatch) and
`paged_attention_apply`'s unfused route on a mesh.

One spawn of 4 gloo ranks on a 2 x 2 (data, model) mesh, beside one
reference subprocess with 4 forced host devices on make_host_mesh(2, 2)
(its Pallas kernel in interpret mode, per shard), on the same numpy
inputs (4 KV heads, G 2, a NaN trash block, mixed lengths, an idle lane):

  * `paged_attention` through the kernel and plain backends (each rank
    attends its 2 KV heads, the pools' heads read in place) equals the
    call without a mesh bit for bit, at decode (C = 1), a prefill chunk
    (C = 4) and a shape past B3's fast case (dh 20, bs 48: the GEN
    pieces), and the reference's head-split dispatch within TOL (the
    plain B3's order is the CUDA kernel's, not Pallas's:
    tests/test_torch_paged_attention.py);
  * one decode step of the smoke internlm2's first layer through
    `paged_attention_apply` on the mesh (paged_write of the whole pools,
    then the split attention) equals the one-launch route without a mesh:
    the output bit for bit, the pools outside the trash block too.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_helpers import one_intra_op_thread, spawn_ranks  # noqa: F401
from _torch_mesh_worker import ATTN_CASES, attn_case

from repro_torch.kernels import paged_attention as pa
from repro_torch.parallel import sharding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_torch_paged_attention.py

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax.numpy as jnp, numpy as np
from repro.kernels import paged_attention as ref_pa
from repro.launch.mesh import make_host_mesh
from repro.parallel import sharding

z = np.load(sys.argv[1])
mesh = make_host_mesh(2, 2)
sharding.set_mesh(mesh)
out = {}
with mesh:
    for name in sys.argv[3:]:
        q, kp, vp, tables, lens, kvl = (jnp.asarray(z[f"{name}_{i}"])
                                        for i in range(6))
        pos = lens[:, None] + jnp.arange(q.shape[1], dtype=jnp.int32)
        out[name] = np.asarray(ref_pa.paged_attention(
            q, kp, vp, tables, positions=pos, kv_len=kvl,
            backend="kernel"))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    where = tmp_path_factory.mktemp("attn_mesh")
    np.savez(where / "attn_inputs.npz", **{
        f"{name}_{i}": a for name, kw in ATTN_CASES.items()
        for i, a in enumerate(attn_case(**kw)[:6])})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(where / "attn_inputs.npz"),
         str(where / "ref.npz"), *ATTN_CASES], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = spawn_ranks("attn", 4, where)
        log = ref.communicate(timeout=600)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log[-3000:]
    with np.load(where / "ref.npz") as z:
        return {k: z[k] for k in z.files}, port


@pytest.mark.parametrize("backend", ["kernel", "plain"])
@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_head_split_bit_exact_vs_no_mesh(runs, name, backend):
    _, port = runs
    for out in port:
        got = out[f"{name}_{backend}_mesh"]
        assert np.isfinite(got).all()
        assert np.array_equal(got, out[f"{name}_{backend}_nomesh"])
        assert np.array_equal(got, port[0][f"{name}_{backend}_mesh"])


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_head_split_matches_reference_mesh(runs, name):
    ref, port = runs
    np.testing.assert_allclose(port[0][f"{name}_kernel_mesh"], ref[name],
                               **TOL)


def test_layer_step_unfused_on_mesh_equals_one_launch(runs):
    """The decode step's output bit for bit; the pools too, outside the
    trash block 0, where the unfused route parks the idle lane's row."""
    _, port = runs
    for out in port:
        assert np.isfinite(out["layer_y_mesh"]).all()
        assert np.array_equal(out["layer_y_mesh"], out["layer_y_nomesh"])
        for n in ("k", "v"):
            assert np.array_equal(out[f"layer_{n}_mesh"][1:],
                                  out[f"layer_{n}_nomesh"][1:])


def test_head_split_rule(monkeypatch):
    """The split needs a live "model" axis that divides KH (else every
    rank attends every head, the reference's fallback)."""
    class Mesh:
        axis_names = ("data", "model")

        def __init__(self, model):
            self.shape = {"data": 2, "model": model}

    for model, kh, want in ((2, 4, True), (4, 4, True), (2, 3, False),
                            (1, 4, False), (8, 4, False)):
        monkeypatch.setattr(sharding, "_MESH", Mesh(model))
        assert pa.head_split(kh) is want, (model, kh)
    monkeypatch.setattr(sharding, "_MESH", None)
    assert pa.head_split(4) is False


def test_head_slice_view_is_read_in_place():
    """A head slice of the pools is the layout B3 reads in place: its row
    stride in heads is the whole pool's; a copy or any other layout is
    refused."""
    pool = torch.zeros(5, 8, 4, 32)
    assert pa._pool_heads(pool) == 4
    assert pa._pool_heads(pool.narrow(2, 2, 2)) == 4
    assert pa._pool_heads(pool.narrow(2, 1, 1)) == 4
    assert pa._pool_heads(pool.transpose(0, 1)) is None
    assert pa._pool_heads(pool.narrow(3, 0, 16)) is None
    assert pa._unit_bytes(20, 4) == 16 and pa._unit_bytes(20, 2) == 8
    assert pa._unit_bytes(3, 2) == 2
