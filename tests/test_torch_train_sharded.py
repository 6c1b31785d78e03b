"""The Trainer's state placed on the mesh (`parallel.sharding`'s
placement, `runtime.trainer` on blocks, `checkpoint.ckpt`'s streamed
saves and block restores) against the port's whole-state Trainer and
against the reference's Trainer on its own mesh.

One spawn of 4 gloo ranks on a 2 x 2 (data, model) mesh (case "fsdp" of
`_torch_mesh_worker.py`) and one of 2 ranks on 2 x 1 ("fsdp2") run beside
a reference subprocess with 4 forced host devices on make_host_mesh(2,
2), which also writes the checkpoint the port resumes; a second,
short reference subprocess restores the port's sharded checkpoint.

  * placement: every leaf of the params, AdamW's m / v, Adafactor's vr /
    vc / v and the error-feedback buffers of the smoke internlm2 and
    qwen2-moe, with FSDP on and off (`set_fsdp(False)`): each rank's
    block is exactly the index range the reference's NamedSharding gives
    the device at the same mesh coordinates, and the distinct blocks of a
    leaf tile it;
  * each rank's resident state bytes equal the dry-run's planned
    per-chip bytes for the same trees (`dryrun.per_chip_bytes`);
  * the sharded Trainer against the whole-state Trainer on the same mesh
    over 3 steps (float32 smoke internlm2): AdamW with a clip that does
    not bind, bit for bit (params and losses; on 2 x 1 too); a binding
    clip, Adafactor and int8 compression within the tolerances below;
    the smoke qwen2-moe at --cim bp under a2a-EP, losses bit for bit;
  * the sharded Trainer and the reference's Trainer, both resuming the
    reference's step-2 checkpoint on the 2 x 2 mesh: the next 3 steps'
    losses within RESUME_TOL and the final params within PARAM_RTOL;
  * a sharded run preempted at step 2 and resumed ends in the blocks of
    an uninterrupted one on every rank, bit for bit, and its checkpoint is
    restored by the reference's CheckpointManager.restore onto
    tree_shardings, equal to the port's gathered params.

Tolerances (measured):
  * binding clip: the global norm is the blocks' sums of squares added
    over the shards in rank order, not the whole tensor's one sum, so the
    clip scale and every update move by float reassociation: CLIP_RTOL
    1e-6 on the params relative to their largest |value|, losses within
    LOSS_RTOL 1e-6 relative (measured 0 and 0 over 3 steps: the last-bit
    moves of the norm did not reach the scale);
  * Adafactor: its row / column means and RMS clip are reassociated the
    same way: CLIP_RTOL on the params (measured 1.2e-7), LOSS_RTOL on the
    losses (measured 7.1e-8);
  * int8 compression: the scale is a max over the shards (exact) and the
    clip does not bind: measured bit for bit, held to CLIP_RTOL;
  * against the reference (test_torch_train.py's): RESUME_TOL 1e-5 on
    the losses (measured 7.3e-8), PARAM_RTOL 1e-5 (its TRAIN_GRAD_TOL) on
    every param leaf relative to the leaf's largest |value| (measured
    5.9e-8 against the whole tree's largest).
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from _torch_helpers import one_intra_op_thread, spawn_ranks  # noqa: F401
from _torch_mesh_worker import (FSDP_ARCHS, FSDP_LEGS, FSDP_SHAPE, ref_key,
                                resume_tc)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLIP_RTOL = 1e-6
LOSS_RTOL = 1e-6
RESUME_TOL = 1e-5
PARAM_RTOL = 1e-5

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import json, shutil
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import ShapeConfig, TrainConfig
from repro.configs.registry import SMOKES
from repro.launch.mesh import make_host_mesh
from repro.models import registry
from repro.parallel import sharding
from repro.runtime.trainer import PreemptionError, Trainer, make_optimizer

out_path, where = sys.argv[1], sys.argv[2]
archs, (seq, batch) = json.loads(sys.argv[3]), json.loads(sys.argv[4])
resume = json.loads(sys.argv[5])
mesh = make_host_mesh(2, 2)
coords = {d.id: ij for ij, d in np.ndenumerate(mesh.devices)}
sharding.set_mesh(mesh)
out = {}


def index_map(tag, tree):
    shs = jax.tree.leaves(sharding.tree_shardings(tree))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for (kp, leaf), sh in zip(flat, shs):
        arr = np.zeros((2, 2, leaf.ndim, 2), np.int64)
        for dev, idx in sh.devices_indices_map(tuple(leaf.shape)).items():
            i, j = coords[dev.id]
            for d, (sl, n) in enumerate(zip(idx, leaf.shape)):
                arr[i, j, d] = sl.indices(n)[:2]
        out[f"place|{tag}|{jax.tree_util.keystr(kp)}"] = arr


for fsdp in (True, False):
    sharding.set_fsdp(fsdp)
    for arch, name in archs.items():
        cfg = SMOKES[name].replace(dtype="float32")
        params = jax.eval_shape(lambda: registry.init_params(
            jax.random.PRNGKey(0), cfg, max_seq=seq + 8))
        for opt in ("adamw", "adafactor"):
            tc = TrainConfig(optimizer=opt, grad_compression=True)
            index_map(f"{arch}|{int(fsdp)}|{opt}", {
                "params": params,
                "opt": jax.eval_shape(make_optimizer(tc).init, params),
                "err": jax.tree.map(lambda p: jax.ShapeDtypeStruct(
                    p.shape, jnp.float32), params)})
sharding.set_fsdp(True)

# the Trainer on the mesh: preempted at step 2 (its step-2 checkpoint is
# the port's start), then resumed to step 5 by the same Trainer
cfg = SMOKES[archs["internlm2"]].replace(dtype="float32")
tr = Trainer(cfg, ShapeConfig("tiny", seq, batch, "train"),
             TrainConfig(**resume), os.path.join(where, "ref_run"),
             preempt_at=2)
try:
    tr.run_once()
except PreemptionError:
    pass
shutil.copytree(os.path.join(where, "ref_run"), os.path.join(where, "ref_ckpt"))
res = tr.run()
out["loss"] = np.array([m["loss"] for m in res["metrics"] if m["step"] >= 2])
for kp, leaf in jax.tree_util.tree_flatten_with_path(res["state"]["params"])[0]:
    out["param|" + jax.tree_util.keystr(kp)] = np.asarray(leaf)
np.savez(out_path, **out)
"""

RESTORE_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import json, re
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.checkpoint import CheckpointManager
from repro.launch.mesh import make_host_mesh
from repro.parallel import sharding

ckpt, step, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
mesh = make_host_mesh(2, 2)
sharding.set_mesh(mesh)
mgr = CheckpointManager(ckpt)
d = os.path.join(ckpt, f"step_{step:010d}")
index = json.load(open(os.path.join(d, "index.json")))
shapes = {k: a.shape for k, a in zip(index["keys"], (
    np.load(os.path.join(d, "arrays.npz"))[f"a{i}"]
    for i in range(len(index["keys"]))))}
like = {}
for k in index["keys"]:          # dicts for names, lists for indices
    path = [m.group(1) if m.group(1) is not None else int(m.group(2))
            for m in re.finditer(r"\[(?:'([^']*)'|(\d+))\]", k)]
    node = like
    for p, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= p:
                node.append([] if isinstance(nxt, int) else {})
            node = node[p]
        else:
            node = node.setdefault(p, [] if isinstance(nxt, int) else {})
    leaf = jax.ShapeDtypeStruct(shapes[k], jnp.dtype(index["dtypes"][k]))
    if isinstance(node, list):
        node.append(leaf)
    else:
        node[path[-1]] = leaf
shardings = sharding.tree_shardings(like)
state, md = mgr.restore(like, step=step, shardings=shardings)
assert int(md["step"]) == step
assert all(isinstance(x.sharding, NamedSharding) and x.sharding.mesh == mesh
           for x in jax.tree.leaves(state))


def leaves(t):                   # the port's tree_leaves order
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in leaves(t[k])]
    if isinstance(t, list):
        return [x for v in t for x in leaves(v)]
    return [t]


np.savez(out_path, params=np.concatenate(
    [np.asarray(x, np.float32).ravel() for x in leaves(state["params"])]))
"""


def _ref(script: str, *args, timeout: float = 300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen([sys.executable, "-c", script, *map(str, args)],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(proc, timeout: float = 300):
    log = proc.communicate(timeout=timeout)[0]
    assert proc.returncode == 0, log[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, the 4 ranks' outputs, the 2 ranks' outputs,
    the reference's restore of the port's checkpoint)."""
    where = tmp_path_factory.mktemp("fsdp")
    ref_out = where / "ref.npz"
    ref = _ref(REF_SCRIPT, ref_out, where, json.dumps(FSDP_ARCHS),
               json.dumps(list(FSDP_SHAPE)), json.dumps(resume_tc()))
    (where / "two").mkdir()
    try:
        two = spawn_ranks("fsdp2", 2, where / "two")
    finally:
        _wait(ref)
    four = spawn_ranks("fsdp", 4, where)
    restored = where / "restored.npz"
    _wait(_ref(RESTORE_SCRIPT, where / "ck_preempted", 4, restored))
    with np.load(ref_out) as z:
        ref_np = {k: z[k] for k in z.files}
    with np.load(restored) as z:
        rest = z["params"]
    shutil.rmtree(where, ignore_errors=True)
    return ref_np, four, two, rest


TAGS = [f"{arch}|{fsdp}|{opt}" for arch in FSDP_ARCHS for fsdp in (1, 0)
        for opt in ("adamw", "adafactor")]


@pytest.mark.parametrize("tag", TAGS)
def test_placement_matches_reference_named_sharding(runs, tag):
    """Every state leaf's block on each rank is the index range the
    reference's NamedSharding gives the device at the rank's mesh
    coordinates."""
    ref, four, _, _ = runs
    prefix = f"place|{tag}|"
    ref_keys = {k for k in ref if k.startswith(prefix)}
    for o in four:
        port_keys = {k for k in o if k.startswith(prefix)}
        assert port_keys == ref_keys, port_keys ^ ref_keys
        i, j = (int(c) for c in o["coords"])
        for k in ref_keys:
            assert np.array_equal(o[k], ref[k][i, j]), (k, o[k], ref[k][i, j])
    # with FSDP the layers' weights are cut over both axes
    if tag.split("|")[1] == "1":
        wq = "['params']['layers']['attn']['wq']"
        assert len({tuple(o[prefix + wq].ravel()) for o in four}) == 4


@pytest.mark.parametrize("tag", TAGS)
def test_blocks_tile_every_leaf(runs, tag):
    """The distinct blocks of a leaf over the ranks cover it once: their
    volumes add up to the whole leaf's."""
    _, four, _, _ = runs
    for k in (k for k in four[0] if k.startswith(f"place|{tag}|")):
        blocks = {tuple(map(tuple, o[k])) for o in four}
        b = np.array(sorted(blocks)).reshape(len(blocks), -1, 2)
        whole = np.prod(b[:, :, 1].max(0) - b[:, :, 0].min(0))
        vol = sum(np.prod(x[:, 1] - x[:, 0]) for x in b)
        assert vol == whole, (k, blocks)


@pytest.mark.parametrize("mesh", ["2x2", "2x1"])
def test_resident_bytes_equal_the_dryrun_plan(runs, mesh):
    """Each rank's resident state bytes (the Trainer's init_state) equal
    the dry-run's planned per-chip bytes for the same trees."""
    _, four, two, _ = runs
    outs = four if mesh == "2x2" else two
    keys = [k for k in outs[0] if k.startswith("bytes|")]
    assert keys
    for o in outs:
        for k in keys:
            resident, planned = o[k]
            assert resident == planned, (k, resident, planned)


@pytest.mark.parametrize("mesh", ["2x2", "2x1"])
def test_sharded_adamw_is_bit_identical_to_whole_state(runs, mesh):
    """AdamW, no compression, a clip that does not bind: the sharded
    Trainer's params (gathered) and losses equal the whole-state
    Trainer's on the same mesh bit for bit, on every rank."""
    _, four, two, _ = runs
    outs = four if mesh == "2x2" else two
    for o in outs:
        assert np.array_equal(o["adamw_placed_params"],
                              o["adamw_whole_params"])
        assert np.array_equal(o["adamw_placed_loss"], o["adamw_whole_loss"])
        assert np.array_equal(o["adamw_placed_params"],
                              outs[0]["adamw_placed_params"])
    assert np.isfinite(outs[0]["adamw_placed_params"]).all()


def test_sharded_microbatches_bit_identical_on_2x1(runs):
    """Microbatches of 2 accumulated into the gradient blocks: the
    sharded Trainer equals the whole-state one bit for bit on 2 x 1."""
    _, _, two, _ = runs
    for o in two:
        assert np.array_equal(o["micro_placed_params"],
                              o["micro_whole_params"])
        assert np.array_equal(o["micro_placed_loss"], o["micro_whole_loss"])
    # the accumulation is another sum than the whole batch's
    assert not np.array_equal(two[0]["micro_placed_params"],
                              two[0]["adamw_placed_params"])


@pytest.mark.parametrize("leg", [leg for leg in FSDP_LEGS if leg != "adamw"])
def test_sharded_legs_within_tolerance(runs, leg):
    """A binding clip, Adafactor and int8 compression: the sharded
    Trainer within CLIP_RTOL (params) and LOSS_RTOL (losses) of the
    whole-state one; every rank holds the same gathered params."""
    _, four, _, _ = runs
    o = four[0]
    a, b = o[f"{leg}_placed_params"], o[f"{leg}_whole_params"]
    err = float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
    assert err <= CLIP_RTOL, err
    la, lb = o[f"{leg}_placed_loss"], o[f"{leg}_whole_loss"]
    assert np.all(np.abs(la - lb) <= LOSS_RTOL * np.abs(lb)), (la, lb)
    assert all(np.array_equal(x[f"{leg}_placed_params"], a) for x in four)
    if leg == "clip":     # the clip binds: the norm is far above 1e-3
        assert np.all(o["clip_placed_gnorm"] > 1.0)


def test_moe_a2a_cim_losses_bit_identical(runs):
    """The smoke qwen2-moe at --cim bp under a2a-EP: the sharded
    Trainer's losses and params equal the whole-state Trainer's."""
    _, four, _, _ = runs
    for o in four:
        assert np.array_equal(o["moe_placed_loss"], o["moe_whole_loss"])
        assert np.array_equal(o["moe_placed_params"], o["moe_whole_params"])
    assert np.isfinite(four[0]["moe_placed_loss"]).all()


def _ref_leaves(ref: dict) -> list:
    """The reference's final params as the port's leaves, in its
    tree_leaves order (a stacked leaf's layer where the port's layer list
    has it)."""
    from repro_torch.configs.registry import SMOKES
    from repro_torch.models import registry
    from repro_torch.optim.optimizers import tree_map
    cfg = SMOKES[FSDP_ARCHS["internlm2"]].replace(dtype="float32")
    params = registry.abstract_params(cfg, max_seq=FSDP_SHAPE[0] + 8)
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            a = ref["param|" + ref_key(path)]
            ints = [k for k in path if isinstance(k, int)]
            out.append(np.asarray(a[ints[0]] if ints else a, np.float32))

    walk(tree_map(lambda t: t, params), ())
    return out


def test_resume_reference_checkpoint_against_reference_trainer(runs):
    """Both Trainers resume the reference's step-2 checkpoint on the 2 x 2
    mesh: the port's sharded run's next 3 losses within RESUME_TOL of the
    reference's, each final param leaf within PARAM_RTOL of the
    reference's largest |value| in it."""
    ref, four, _, _ = runs
    o = four[0]
    assert len(ref["loss"]) == 3 and len(o["resume_loss"]) == 3
    assert np.all(np.abs(o["resume_loss"] - ref["loss"])
                  <= RESUME_TOL * np.abs(ref["loss"])), \
        (o["resume_loss"], ref["loss"])
    want = _ref_leaves(ref)
    got = np.split(o["resume_params"],
                   np.cumsum([w.size for w in want])[:-1])
    assert sum(w.size for w in want) == o["resume_params"].size
    for g, w in zip(got, want):
        assert float(np.max(np.abs(g - w.ravel()))) \
            <= PARAM_RTOL * float(np.max(np.abs(w)))
    assert all(np.array_equal(x["resume_params"], o["resume_params"])
               for x in four)


def test_checkpoint_reads_back_onto_the_blocks(runs):
    """Each sharded run's last checkpoint (written whole by rank 0), read
    with `CheckpointManager.restore(like, specs=...)`, gives every rank
    its own blocks back: params, AdamW or Adafactor state, error
    feedback."""
    _, four, two, _ = runs
    for outs in (four, two):
        keys = [k for k in outs[0] if k.endswith("_restored")]
        assert len(keys) >= 2
        for o in outs:
            assert all(bool(o[k]) for k in keys), \
                [k for k in keys if not o[k]]


def test_preempted_sharded_run_resumes_bit_identically(runs):
    """Preempted at step 2 and resumed from rank 0's whole checkpoint,
    each rank's blocks end where an uninterrupted sharded run's do."""
    _, four, _, _ = runs
    for o in four:
        assert np.array_equal(o["straight_blocks"], o["preempted_blocks"])
        assert np.array_equal(o["straight_loss"], o["preempted_loss"])
    # the ranks hold different blocks of one state
    assert len({o["straight_blocks"].tobytes() for o in four}) > 1


def test_reference_restores_the_sharded_checkpoint(runs):
    """The sharded run's step-4 checkpoint, restored by the reference's
    CheckpointManager.restore onto tree_shardings on its 2 x 2 mesh, holds
    the port's gathered params, bit for bit."""
    _, four, _, restored = runs
    assert np.array_equal(restored, four[0]["preempted_params"])


# ---------------------------------------------------------------------------
# the placement helpers in one process (a planned mesh, meta tensors)
# ---------------------------------------------------------------------------
def test_planned_mesh_places_rank0_blocks_and_records_gathers():
    """Under a PlannedMesh, rank 0's block of a leaf cut over both axes is
    a meta tensor of the block's shape; inside `placed_state` the models'
    `gathered` reads it whole, each gather recorded as state traffic, and
    its backward gives the block's gradient shape."""
    import torch
    from repro_torch.analysis import hlo
    from repro_torch.parallel import sharding
    sharding.set_mesh(sharding.PlannedMesh({"data": 4, "model": 2}))
    try:
        w = torch.empty((8, 6), device="meta")
        spec = sharding.leaf_spec(("layers", 0, "attn", "wq"), w.shape)
        assert spec == ("data", "model")
        assert sharding.block_bounds(w.shape, spec) == ((0, 2), (0, 3))
        block = sharding.place(w, spec).requires_grad_()
        assert block.shape == (2, 3) and block.device.type == "meta"
        tree = {"attn": {"wq": block}}
        with hlo.recording() as rec, \
                sharding.placed_state(tree, {"attn": {"wq": spec}}):
            whole = sharding.gathered(tree)["attn"]["wq"]
            (g,) = torch.autograd.grad(whole.sum(), [block])
        assert whole.shape == (8, 6) and g.shape == (2, 3)
        kinds = [k for k, _ in rec.collectives]
        assert kinds == ["all-gather", "all-gather"]
        assert rec.state_collectives == rec.collectives
        # a replicated leaf and code outside placed_state read as they are
        assert sharding.gathered(tree) is tree
        norm = sharding.leaf_spec(("layers", 0, "norm1", "scale"), (6,))
        assert norm == (None,) and not sharding.spec_axes(norm)
    finally:
        sharding.set_mesh(None)


@pytest.mark.parametrize("plan", [{"data": 1, "model": 1}, None])
def test_no_mesh_or_one_rank_cuts_no_leaf(plan):
    """Without a mesh, and on a 1-rank mesh, the Trainer's state specs cut
    nothing: `state_specs` is None and the state stays whole."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import SMOKES
    from repro_torch.parallel import sharding
    from repro_torch.runtime.trainer import state_specs
    sharding.set_mesh(None if plan is None else sharding.PlannedMesh(plan))
    try:
        for opt in ("adamw", "adafactor"):
            assert state_specs(SMOKES["qwen2-moe-a2.7b"],
                               TrainConfig(optimizer=opt,
                                           grad_compression=True)) is None
    finally:
        sharding.set_mesh(None)
