"""The port's MoE expert parallelism (`models/moe.py`'s mesh branches,
`parallel/collectives.a2a_dispatch` / `a2a_combine`) and the Trainer on a
mesh, against the reference on its own mesh (tests/test_moe_distributed.py's
model and cases).

One spawn of 4 gloo ranks on a 2 x 2 (data, model) mesh runs beside one
reference subprocess with 4 forced host devices on make_host_mesh(2, 2),
and one spawn of 6 ranks (2 x 3) beside one with 6, on the same
numpy-seeded weights and inputs (x [4, 8, 32], the decode xd [8, 1, 32]):

  * psum-EP and a2a-EP, prefill and decode (t = 1: a2a's masked chunks),
    float32 at --cim off and nibble-packed experts at IDEAL and NOISY
    (noise_seed 0): within APPLY_RTOL of the reference's same mesh. Not
    bit for bit: the routing softmax and SiLU differ from XLA's in the
    last bit, as on the local path (tests/test_torch_moe.py holds it to
    the same APPLY_RTOL). The layout is what the test holds: under CIM
    the reference's mesh differs from its own local path by more than
    LAYOUT_GAP (each expert's DAC grid over its own buffer, capacities
    from the local token count), and the port follows the mesh's;
  * at --cim off (no grid), the mesh equals the port's own local path bit
    for bit: psum-EP adds two partials over "model" (top-2: at most one
    choice on each rank), a2a-EP combines each token on its source;
  * the gradients of Σ y·gy + 0.01·aux under train (float experts at
    --cim off, and --cim bp through the expert STE on B2e's plain
    version) within GRAD_RTOL of the reference's jax.grad on the mesh;
  * on 2 x 3 the batch-sharded fallback ("model" does not divide the 16
    padded experts), with the exact load-balance loss (the raw router
    sums added over the batch axes) equal to the local path's within
    AUX_RTOL;
  * every rank holds the same bits;
  * a Trainer (smoke qwen2-moe, --cim bp, a2a-EP) preempted at step 2
    and resumed on the 2 x 2 mesh ends in the state of an uninterrupted
    run on that mesh, bit for bit.

Two ranks (1 x 2) hold the a2a exchange's layout, its inverse and its
gradient, and the gradients of operands that every rank's block of a
sharded MVM reads whole (`sharding.shard` with no live slice sums them
over the partitioning axes).
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_helpers import one_intra_op_thread, spawn_ranks  # noqa: F401
from _torch_mesh_worker import MOE_LEGS, a2a_send

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# moe.apply against the reference, relative to the output's largest
# |value| (tests/test_torch_moe.py's APPLY_RTOL; measured up to 4.8e-7)
APPLY_RTOL = 1e-6
# the load-balance loss (measured up to 1.2e-7: XLA's sums of probs)
AUX_RTOL = 1e-6
# each gradient leaf relative to its largest |value| (measured up to
# 6.2e-7, the router's)
GRAD_RTOL = 2e-6
# the reference's own mesh against its local path under CIM, relative
# (measured 0.78 to 3.0): the layout decides every output
LAYOUT_GAP = 1e-2

REF_SCRIPT = r"""
import os, sys
N = int(sys.argv[3])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N}"
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("REPRO_FORCE_JNP", None)
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import ModelConfig, MoEConfig
from repro.core.cim_matmul import CIMConfig
from repro.core.macro import SimLevel
from repro.launch.mesh import make_host_mesh
from repro.models import moe
from repro.models.quantize import quantize_params
from repro.parallel import sharding


def cfg_of(leg, mode="psum"):
    cfg = ModelConfig(arch="t", family="moe", n_layers=2, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=16, vocab=64,
                      dtype="float32",
                      moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=16,
                                    capacity_factor=8.0, ep_mode=mode))
    if leg in ("ideal", "bp"):
        cfg = cfg.replace(cim=CIMConfig(enabled=True))
    elif leg == "noisy":
        cfg = cfg.replace(cim=CIMConfig(
            enabled=True, noise_seed=0, macro=dataclasses.replace(
                CIMConfig().macro, sim_level=SimLevel.NOISY)))
    return cfg


z = np.load(sys.argv[1])
inp = {k: jnp.asarray(z[k]) for k in z.files}
names = ("router", "e_gate", "e_up", "e_down")


def params(leg):
    p = {k: inp[k] for k in names}
    if leg in ("ideal", "noisy"):
        p = quantize_params(p, cfg_of(leg), packed=True)
    return p


if N == 4:
    legs, modes, glegs = ("off", "ideal", "noisy"), ("psum", "a2a"), \
        ("off", "bp")
else:
    legs, modes, glegs = ("off", "ideal"), ("psum",), ("off",)
mesh = make_host_mesh(2, N // 2)
out = {}
for use_mesh in (True, False):
    sharding.set_mesh(mesh if use_mesh else None)
    pre = "" if use_mesh else "nomesh_"
    with mesh:
        for leg in legs:
            p = params(leg)
            for mode in modes:
                c = cfg_of(leg, mode)
                f = jax.jit(lambda pp, xx, c=c: moe.apply(pp, xx, c))
                for shape in ("prefill", "decode"):
                    y, aux = f(p, inp["x" if shape == "prefill" else "xd"])
                    out[f"{pre}{leg}_{mode}_{shape}_y"] = np.asarray(y)
                    out[f"{pre}{leg}_{mode}_{shape}_aux"] = np.asarray(aux)
        if not use_mesh:
            continue
        for leg in glegs:
            for mode in modes:
                c = cfg_of(leg, mode)

                def loss(x, pp, c=c):
                    y, aux = moe.apply(pp, x, c, train=True)
                    return jnp.sum(y * inp["gy"]) + 0.01 * aux, (y, aux)
                (_, (y, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
                    loss, argnums=(0, 1), has_aux=True))(inp["x"],
                                                         params(leg))
                tag = f"g_{leg}_{mode}"
                out[tag + "_y"], out[tag + "_aux"] = np.asarray(y), \
                    np.asarray(aux)
                out[tag + "_x"] = np.asarray(gx)
                for n in names:
                    out[f"{tag}_{n}"] = np.asarray(gp[n])
np.savez(sys.argv[2], **out)
"""


def _inputs(path):
    """The reference test's shapes, numpy-seeded: router [32, 16] · 0.02,
    the expert stacks at the reference's init scales, x, xd and the
    upstream gradient gy."""
    rng = np.random.RandomState(0)
    d, e, f = 32, 16, 16
    inp = dict(
        router=rng.standard_normal((d, e)) * 0.02,
        e_gate=rng.standard_normal((e, d, f)) / math.sqrt(d),
        e_up=rng.standard_normal((e, d, f)) / math.sqrt(d),
        e_down=rng.standard_normal((e, f, d)) / math.sqrt(f * 2 * 2),
        x=rng.standard_normal((4, 8, d)),
        xd=rng.standard_normal((8, 1, d)),
        gy=rng.standard_normal((4, 8, d)))
    np.savez(path, **{k: v.astype(np.float32) for k, v in inp.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: (the reference's outputs, the port's per-rank outputs)} for
    4 and 6, and the 2-rank a2a case's per-rank outputs: both reference
    subprocesses run while the port's ranks do."""
    where = tmp_path_factory.mktemp("moe_ep")
    _inputs(str(where / "moe_inputs.npz"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    refs = {n: subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(where / "moe_inputs.npz"),
         str(where / f"ref{n}.npz"), str(n)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in (4, 6)}
    try:
        port = {4: spawn_ranks("moe", 4, where),
                6: spawn_ranks("moe6", 6, where),
                2: spawn_ranks("a2a", 2, where)}
        logs = {n: p.communicate(timeout=600)[0] for n, p in refs.items()}
    finally:
        for p in refs.values():
            if p.poll() is None:
                p.kill()
    out = {2: port[2]}
    for n, p in refs.items():
        assert p.returncode == 0, logs[n][-3000:]
        with np.load(where / f"ref{n}.npz") as z:
            out[n] = ({k: z[k] for k in z.files}, port[n])
    return out


def _close(a, b, rtol):
    return float(np.max(np.abs(a - b))) <= rtol * float(np.max(np.abs(b)))


FORWARDS = [f"{leg}_{mode}_{shape}" for leg in MOE_LEGS
            for mode in ("psum", "a2a") for shape in ("prefill", "decode")]


@pytest.mark.parametrize("name", FORWARDS)
def test_four_ranks_match_reference_mesh(runs, name):
    """y and aux on the 2 x 2 mesh against the reference's same mesh; the
    same bits on every rank."""
    ref, port = runs[4]
    y, aux = port[0][name + "_y"], port[0][name + "_aux"]
    assert y.shape == ref[name + "_y"].shape and np.isfinite(y).all()
    assert all(np.array_equal(o[name + "_y"], y)
               and np.array_equal(o[name + "_aux"], aux) for o in port)
    assert _close(y, ref[name + "_y"], APPLY_RTOL), name
    assert _close(aux, ref[name + "_aux"], AUX_RTOL), name


@pytest.mark.parametrize("leg", ["ideal", "noisy"])
def test_cim_outputs_follow_the_mesh_layout(runs, leg):
    """Under CIM the reference's mesh output is not its local one (each
    expert's grid over its own buffer): the port matches the mesh's, far
    from the local path's."""
    ref, port = runs[4]
    for shape in ("prefill", "decode"):
        name = f"{leg}_psum_{shape}_y"
        assert not _close(ref[name], ref["nomesh_" + name], LAYOUT_GAP)
        assert _close(port[0][name], ref[name], APPLY_RTOL)


@pytest.mark.parametrize("shape", ["prefill", "decode"])
@pytest.mark.parametrize("mode", ["psum", "a2a"])
def test_float_mesh_equals_local_path_bit_for_bit(runs, mode, shape):
    """At --cim off the mesh's output is the port's local path's, bit for
    bit (top-2 over two "model" ranks: psum-EP adds two partials)."""
    _, port = runs[4]
    assert np.array_equal(port[0][f"off_{mode}_{shape}_y"],
                          port[0][f"nomesh_off_psum_{shape}_y"])


GRADS = [f"g_{leg}_{mode}" for leg in ("off", "bp")
         for mode in ("psum", "a2a")]


@pytest.mark.parametrize("tag", GRADS)
def test_four_ranks_gradients_match_reference(runs, tag):
    """The gradients of x and of the float weights through the EP paths
    (and the expert STE at bp) against the reference's jax.grad on the
    same mesh; whole and equal on every rank."""
    ref, port = runs[4]
    assert _close(port[0][tag + "_y"], ref[tag + "_y"], APPLY_RTOL)
    for n in ("x", "router", "e_gate", "e_up", "e_down"):
        g = port[0][f"{tag}_{n}"]
        assert np.isfinite(g).all() and np.abs(g).max() > 0, n
        assert all(np.array_equal(o[f"{tag}_{n}"], g) for o in port), n
        assert _close(g, ref[f"{tag}_{n}"], GRAD_RTOL), (tag, n)


@pytest.mark.parametrize("name", ["off_psum_prefill", "off_psum_decode",
                                  "ideal_psum_prefill", "ideal_psum_decode",
                                  "g_off_psum"])
def test_six_ranks_fallback_matches_reference(runs, name):
    """2 x 3: the batch-sharded fallback against the reference's, and (at
    --cim off) its load-balance loss equal to the local path's: the exact
    loss, not the mean of shard estimators."""
    ref, port = runs[6]
    y, aux = port[0][name + "_y"], port[0][name + "_aux"]
    assert all(np.array_equal(o[name + "_y"], y) for o in port)
    assert _close(y, ref[name + "_y"], APPLY_RTOL)
    assert _close(aux, ref[name + "_aux"], AUX_RTOL)
    if name.startswith("off"):
        local = runs[4][1][0]["nomesh_" + name + "_aux"]
        assert _close(aux, local, AUX_RTOL)
        assert np.array_equal(y, runs[4][1][0]["nomesh_" + name + "_y"])
    if name.startswith("g_"):
        for n in ("x", "router", "e_gate", "e_up", "e_down"):
            assert _close(port[0][f"{name}_{n}"], ref[f"{name}_{n}"],
                          GRAD_RTOL), n


def test_four_ranks_psum_loss_is_the_shard_mean(runs):
    """psum-EP's loss is the mean of the batch shards' estimators (the
    reference's pmean): not the local path's exact loss."""
    _, port = runs[4]
    assert port[0]["off_psum_prefill_aux"] != \
        port[0]["nomesh_off_psum_prefill_aux"]


def test_a2a_exchange_layout_and_inverse(runs):
    """recv[e, s·cap + c] is source s's slot (rank·E_local + e, c);
    a2a_combine gives every source its send back; the dispatch's gradient
    is the combine of the upstream gradient."""
    out = runs[2]
    sends = [a2a_send(r) for r in range(2)]
    e_local, cap = 2, 3
    for rank, o in enumerate(out):
        want = np.concatenate([s[rank * e_local:(rank + 1) * e_local]
                               for s in sends], axis=1)
        assert o["recv"].shape == (e_local, 2 * cap, 5)
        assert np.array_equal(o["recv"], want)
        assert np.array_equal(o["back"], sends[rank])
        assert np.array_equal(o["send_grad"], o["combined_g"])
    # the combine is the inverse placement of the gradients too
    for rank, o in enumerate(out):
        for s in range(2):
            got = o["combined_g"][s * e_local:(s + 1) * e_local]
            assert np.array_equal(got, out[s]["g"][:, rank * cap:
                                                   (rank + 1) * cap])


def test_trainer_resume_on_mesh_bit_identical(runs):
    """A Trainer preempted at step 2 and resumed from rank 0's checkpoint
    on the 2 x 2 mesh ends where an uninterrupted run on that mesh ends,
    bit for bit, the same on every rank."""
    _, port = runs[4]
    a, b = port[0]["train_straight"], port[0]["train_resumed"]
    assert np.isfinite(a).all()
    assert np.array_equal(a, b)
    assert np.array_equal(port[0]["train_straight_loss"],
                          port[0]["train_resumed_loss"])
    assert all(np.array_equal(o["train_resumed"], a) for o in port)


@pytest.mark.parametrize("name", ["xgrad", "wgrad"])
def test_replicated_operand_gradients_sum_over_ranks(runs, name):
    """On a 1 x 2 mesh the sharded MVM splits only N over "model": x (and
    w's whole K) are read whole by both ranks' blocks, so their gradients
    are the sum of both ranks' shares, within float reassociation of no
    mesh's (2e-5 of the largest), equal on both ranks."""
    out = runs[2]
    g, g0 = out[0][name + "_mesh"], out[0][name + "_nomesh"]
    assert all(np.array_equal(o[name + "_mesh"], g) for o in out)
    assert np.max(np.abs(g - g0)) <= 2e-5 * np.max(np.abs(g0))
