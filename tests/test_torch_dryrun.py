"""The port's lowering analysis (launch/dryrun.py, analysis/{roofline, hlo,
report, perf_report}.py, launch/perf.py and the dry-run helpers) against
the reference's: cell_is_runnable's verdicts; the abstract params,
quantized params, optimizer state, inputs and caches of every arch at
full width, leaf for leaf (the port's per-layer lists stacked by path);
count_params / count_active_params / model_flops; every leaf's partition
spec and each cell's per-chip argument bytes on the production meshes,
with FSDP on and off (the reference side in one subprocess with 512
placeholder devices, `_torch_dryrun_ref.py`); the collectives that a
planned 2 x 2 mesh records against a real 4-rank gloo run; run_cell's
JSON, skips and the extrapolation; the MVM cost hook; the reports."""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from _torch_helpers import normalize, one_intra_op_thread  # noqa: F401

from repro.analysis import roofline as ref_roofline
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.configs.registry import cell_is_runnable as ref_runnable
from repro.configs.base import SHAPES as REF_SHAPES
from repro_torch.analysis import hlo, roofline
from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.configs.registry import ARCHS, SMOKES, cell_is_runnable
from repro_torch.core.cim_matmul import CIMConfig
from repro_torch.launch import dryrun as dr
from repro_torch.models import registry
from repro_torch.models.quantize import abstract_quantized_params
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import PlannedMesh
from repro_torch.runtime.trainer import make_train_step

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARCH_IDS = sorted(ARCHS)
STACKS = ("dense_layers", "layers", "enc_layers")


# ---------------------------------------------------------------------------
# the two sides' trees
# ---------------------------------------------------------------------------
def _run_ref(out) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_dryrun_ref.py"),
         str(out)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """The reference side (`_torch_dryrun_ref.py`, one subprocess) and the
    4-rank gloo run of the collectives test, started with the module's
    first test and run beside the port-only tests."""
    from _torch_helpers import spawn_ranks
    pool = concurrent.futures.ThreadPoolExecutor(2)
    jobs = {"ref": pool.submit(
                _run_ref, tmp_path_factory.mktemp("dryrun_ref") / "r.json"),
            "gloo": pool.submit(spawn_ranks, "dryrun", 4,
                                tmp_path_factory.mktemp("dryrun_mesh"))}
    yield jobs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ref(background):
    return background["ref"].result()


@pytest.fixture(scope="module")
def gloo_records(background):
    return background["gloo"].result()


def _smoke(arch: str):
    """The smoke config at the full config's attention chunk: the cells'
    shapes (4k-32k tokens) at the smoke chunk of 64 would trace ~10^5
    chunk pairs."""
    return SMOKES[arch].replace(attn_chunk=ARCHS[arch].attn_chunk)


def _max_seq(shape) -> int:
    return shape.seq_len + (8 if shape.kind != "train" else 0)


_TREES: dict = {}


def port_trees(arch: str) -> dict:
    """The port's abstract trees of `arch` (as the reference side builds
    them), made once."""
    if arch not in _TREES:
        cfg = ARCHS[arch]
        mod = registry.get_module(cfg)
        learned = cfg.pos_embed == "learned"
        params = {}

        def params_for(shape):
            ms = _max_seq(shape) if learned else 0
            if ms not in params:
                params[ms] = registry.abstract_params(cfg, max_seq=ms)
            return params[ms]

        quantized = {}

        def quantized_for(shape):
            ms = _max_seq(shape) if learned else 0
            if ms not in quantized:
                quantized[ms] = abstract_quantized_params(params_for(shape),
                                                          cfg)
            return quantized[ms]

        p0 = params_for(SHAPES["decode_32k"])
        tc = TrainConfig(optimizer=dr.choose_optimizer(p0))
        _, opt = make_train_step(cfg, tc)
        _TREES[arch] = {
            "params_for": params_for, "quantized_for": quantized_for,
            "params": p0, "quantized": quantized_for(SHAPES["decode_32k"]),
            "opt": opt.init(params_for(SHAPES["train_4k"])),
            "optimizer": tc.optimizer,
            "inputs": {n: registry.input_specs(cfg, s)
                       for n, s in SHAPES.items()},
            "caches": {n: mod.init_cache(cfg, s.global_batch, s.seq_len,
                                         device="meta")
                       for n, s in SHAPES.items() if s.kind == "decode"}}
    return _TREES[arch]


def _walk(tree, path=()):
    """(path of keys and list indices, leaf) over dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _stacked(tree, specs=None) -> dict:
    """{path: [shape, dtype(, spec)]} of a port tree, every per-layer list
    stacked as the reference's [L, ...] leaf (its spec with the stack's
    leading None); every layer must agree."""
    out: dict = {}
    for path, t in _walk(tree):
        n = None
        for i, k in enumerate(path[:-1]):
            if isinstance(path[i + 1], int) and k in STACKS:
                n = len(_get(tree, path[:i + 1]))
        rec = [list(t.shape), str(t.dtype).replace("torch.", "")]
        if specs is not None:
            rec.append([list(e) if isinstance(e, tuple) else e
                        for e in _get(specs, path)])
        if n is not None:
            rec[0] = [n] + rec[0]
            if specs is not None:
                rec[2] = [None] + rec[2]
        key = "/".join(str(k) for k in path if not isinstance(k, int))
        assert out.setdefault(key, rec) == rec, (key, out[key], rec)
    return out


def _get(node, path):
    for k in path:
        node = node[k]
    return node


def _ref_leaves(recs) -> dict:
    return {p: [s, d] for p, s, d in recs}


# ---------------------------------------------------------------------------
# (a) cell_is_runnable
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_is_runnable(arch, shape):
    assert cell_is_runnable(ARCHS[arch], SHAPES[shape]) == \
        ref_runnable(REF_ARCHS[arch], REF_SHAPES[shape])


# ---------------------------------------------------------------------------
# (f) the reference's per-layer extrapolation; a failing cell
# ---------------------------------------------------------------------------
XP_CELLS = [("internlm2-1.8b", "decode_32k", "bp-noisy"),
            ("internlm2-1.8b", "train_4k", "off"),
            ("deepseek-v3-671b", "decode_32k", "bp-noisy"),
            ("qwen2-moe-a2.7b", "decode_32k", "bp-prequant"),
            ("zamba2-2.7b", "decode_32k", "bp-noisy"),
            ("whisper-large-v3", "train_4k", "off"),
            ("rwkv6-7b", "decode_32k", "bp")]


@pytest.mark.parametrize("arch,shape,cim", XP_CELLS)
def test_extrapolate_equals_direct(arch, shape, cim):
    """The reference's per-layer differencing reproduces the port's direct
    trace exactly (smoke configs at the cells' shapes)."""
    cfg = _smoke(arch)
    direct = dr.run_cell(arch, shape, "single", cim=cim, cfg_override=cfg)
    xp = dr.run_cell(arch, shape, "single", cim=cim, cfg_override=cfg,
                     analysis="extrapolate")
    assert direct["status"] == xp["status"] == "ok", \
        (direct.get("error"), xp.get("error"))
    assert xp["cell"] == direct["cell"] + "__xp"
    assert xp["cost_basis"] == "unrolled-per-layer-extrapolation"
    a, b = direct["roofline"], xp["roofline"]
    for k in ("hlo_flops", "hlo_bytes", "collective_bytes", "model_flops"):
        assert a[k] == b[k], k
    assert a["hlo_flops"] > 0 and a["hlo_bytes"] > 0
    assert a["collective_detail"]["bytes"] == b["collective_detail"]["bytes"]
    if cim == "bp-noisy":       # the stochastic kernels are partitioned
        assert a["collective_bytes"] > 0
    # a step that issues no collective is the whole model's (one chip);
    # so is a train step whose only collectives move its placed state
    state = a["collective_detail"]["state_bytes"]
    whole = a["collective_bytes"] == state
    assert direct["program"] == xp["program"] == \
        ("rank0-partitioned" if not whole else "rank0-sharded-state"
         if state else "rank0-whole-tensors")
    assert a["work_chips"] == b["work_chips"] == (1 if whole else 256)
    # the train cells' state is placed: its gathers are recorded
    assert (state > 0) == (shape == "train_4k")
    assert a["useful_ratio"] == pytest.approx(
        a["model_flops"] / a["work_chips"] / a["hlo_flops"])


def test_prequant_mla_decode_errors():
    """deepseek-v3's prequantized decode fails as the reference's does
    (the absorbed MLA decode reads the float w_uk)."""
    r = dr.run_cell("deepseek-v3-671b", "decode_32k", "single",
                    cim="bp-prequant",
                    cfg_override=SMOKES["deepseek-v3-671b"])
    assert r["status"] == "error"
    assert r["error"].startswith("KeyError: 'w_uk")


# ---------------------------------------------------------------------------
# the MVM cost hook and the step counter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("packed,experts", [(True, 0), (False, 0),
                                            (True, 4), (False, 4)])
def test_meta_mvm_counts_kernel_work(packed, experts):
    from repro_torch.core.engine import PackedCodes, execute_mvm
    from repro_torch.runtime.telemetry import KERNEL_COUNTERS
    m, k, n = 6, 288, 40
    lead = (experts,) if experts else ()
    x = torch.empty(lead + (m, k), device="meta")
    cfg = CIMConfig(enabled=True)
    one = torch.ones(lead + (1, 1), device="meta")
    if packed:
        w = PackedCodes(torch.empty(lead + (k // 2, n), dtype=torch.uint8,
                                    device="meta"), k, one)
    else:
        w = torch.empty(lead + (k, n), device="meta")
    before = sum(KERNEL_COUNTERS.backend_dispatch.values())
    with hlo.recording() as rec:
        y = execute_mvm(x, w, cfg, s_x=one, s_w=one, x_zero_point=one)
    assert y.shape == lead + (m, n) and y.device.type == "meta"
    e = max(experts, 1)
    assert (rec.mvms, rec.mvm_flops) == (1, 2 * e * m * k * n)
    w_bytes = e * k * n // 2 if packed else 4 * e * k * n
    assert rec.mvm_bytes == e * m * k * 4 + w_bytes + e * m * n * 4
    assert sum(KERNEL_COUNTERS.backend_dispatch.values()) == before + 1


def test_count_costs_temp_and_alias():
    """The step counter's FLOPs, bytes, peak live bytes and aliasing."""
    a = torch.empty(64, 128, device="meta")
    b = torch.empty(128, 32, device="meta")
    cache = torch.empty(8, 32, device="meta")
    with hlo.count_costs((a, b, cache)) as cost:
        y = a @ b                       # 2·64·128·32 FLOPs
        z = torch.relu(y)
        del y                           # freed: the peak stays y + z
        cache[:4] = z[:4, :32]          # in place: no allocation
        cost.result = (z, cache)
    assert cost.flops == 2 * 64 * 128 * 32
    assert cost.temp_bytes == 2 * 64 * 32 * 4
    assert cost.output_bytes == 64 * 32 * 4
    assert cost.alias_bytes == 8 * 32 * 4
    mm = (64 * 128 + 128 * 32 + 64 * 32) * 4
    assert cost.bytes >= mm + 2 * 64 * 32 * 4


# ---------------------------------------------------------------------------
# the reports and launch/perf
# ---------------------------------------------------------------------------
def test_reports_and_perf(tmp_path, monkeypatch, capsys):
    from repro.analysis import report as ref_report
    from repro.launch import perf as ref_perf
    from repro_torch.analysis import perf_report, report
    from repro_torch.launch import perf
    assert sorted(perf.VARIANTS) == sorted(ref_perf.VARIANTS)
    for vid, spec in perf.VARIANTS.items():
        rspec = ref_perf.VARIANTS[vid]
        assert spec[:3] + spec[4:] == rspec[:3] + rspec[4:], vid
        assert normalize(spec[3]) == normalize(rspec[3]), vid
    cells = [dr.run_cell("internlm2-1.8b", s, "single",
                         cfg_override=_smoke("internlm2-1.8b"), analysis=a,
                         out_dir=str(tmp_path / "dr"))
             for s in ("decode_32k", "train_4k")
             for a in ("scan", "extrapolate")]
    cells.append(dr.run_cell("llama3-8b", "long_500k", "single",
                             out_dir=str(tmp_path / "dr")))
    loaded = report.load_cells(str(tmp_path / "dr"))
    assert sorted(c["cell"] for c in loaded) == sorted(c["cell"]
                                                       for c in cells)
    for fn in ("roofline_table", "dryrun_table"):
        ours = getattr(report, fn)(loaded).splitlines()
        theirs = getattr(ref_report, fn)(loaded).splitlines()
        assert ours[:2] == theirs[:2] and len(ours) == len(theirs) > 2
    # one variant through launch/perf, then its report
    monkeypatch.setattr(perf, "VARIANTS", {"C9": (
        "internlm2-1.8b", "decode_32k", "bp-prequant",
        SMOKES["internlm2-1.8b"], "smoke")})
    monkeypatch.setattr(sys, "argv", ["perf", "--out", str(tmp_path / "p")])
    perf.main()
    assert "[C9] dom=" in capsys.readouterr().out
    assert not dr.TC_OVERRIDES and sharding._FSDP
    monkeypatch.setattr(sys, "argv", ["perf_report", "--dir",
                                      str(tmp_path / "p")])
    perf_report.main()
    assert "| C9 | internlm2-1.8b×decode_32k |" in capsys.readouterr().out
# ---------------------------------------------------------------------------
# (c) parameter counts and model FLOPs; the roofline's arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_and_model_flops(arch, ref):
    cfg = ARCHS[arch]
    p = port_trees(arch)
    for n, s in SHAPES.items():
        for cim in ("off", "bp-prequant"):
            pt = p["quantized_for" if cim == "bp-prequant"
                   else "params_for"](s)
            assert [roofline.count_params(pt),
                    roofline.count_active_params(pt, cfg),
                    roofline.model_flops(cfg, s, pt)] == \
                ref["counts"][arch][f"{n}/{cim}"], (n, cim)


def test_roofline_terms_and_dominance():
    """The reference's roofline arithmetic test on the H100's peaks."""
    rl = roofline.Roofline(
        arch="x", shape="train_4k", mesh="m", chips=256,
        hlo_flops=roofline.PEAK_FLOPS, hlo_bytes=roofline.HBM_BW * 2,
        collective_bytes=roofline.LINK_BW * 0.5,
        model_flops=roofline.PEAK_FLOPS * 256 * 0.8,
        peak_bytes_per_chip=0, collective_detail={})
    assert rl.t_compute == pytest.approx(1.0)
    assert rl.t_memory == pytest.approx(2.0)
    assert rl.t_collective == pytest.approx(0.5)
    assert rl.dominant == "memory"
    assert rl.useful_ratio == pytest.approx(0.8)
    assert rl.roofline_fraction == pytest.approx(0.4)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989.4e12, 3.35e12, 450e9)
    wire = dataclasses.replace(rl, collective_detail={"bytes": {
        "all-reduce": 10.0, "all-gather": 3.0}})
    assert wire.wire_bytes == 23.0
    assert wire.to_dict().keys() == ref_roofline.Roofline(
        **{f.name: getattr(rl, f.name) for f in dataclasses.fields(rl)
           if f.name != "work_chips"}).to_dict().keys() | {"work_chips"}
    # a program that is the whole model's on one chip: model_flops whole
    one = dataclasses.replace(rl, work_chips=1)
    assert one.useful_ratio == pytest.approx(0.8 * 256)
    assert one.roofline_fraction == pytest.approx(0.4 * 256)
    assert (rl.to_dict()["work_chips"], one.to_dict()["work_chips"]) == \
        (256, 1)


# ---------------------------------------------------------------------------
# (b) abstract params, quantized params, optimizer state, inputs, caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_trees(arch, ref):
    r, p = ref["abstract"][arch], port_trees(arch)
    for t in _walk(p["params"]):
        assert t[1].device.type == "meta"
    for name in ("params", "quantized", "opt"):
        assert _stacked(p[name]) == _ref_leaves(r[name]), name
    assert p["optimizer"] == r["optimizer"]
    for n in SHAPES:
        assert _stacked(p["inputs"][n]) == _ref_leaves(r["inputs"][n]), n
    assert set(p["caches"]) == set(r["caches"])
    for n, c in p["caches"].items():
        assert _stacked(c) == _ref_leaves(r["caches"][n]), n


# ---------------------------------------------------------------------------
# (d) partition specs and per-chip argument bytes on the production meshes
# ---------------------------------------------------------------------------
def _specs(tree, specs) -> dict:
    return {k: v[2] for k, v in _stacked(tree, specs).items()}


def _port_bytes(p, arch, mesh) -> dict:
    cfg = ARCHS[arch]
    out = {}
    for n, s in SHAPES.items():
        if not cell_is_runnable(cfg, s)[0]:
            continue
        for cim in ("off", "bp-prequant"):
            if cim == "bp-prequant" and s.kind == "train":
                continue
            pt = p["quantized_for" if cim == "bp-prequant"
                   else "params_for"](s)
            args = [dr.Placed(pt, dr.params_shardings(pt, mesh)),
                    dr.Placed(p["inputs"][n],
                              dr.batch_shardings(p["inputs"][n], mesh))]
            if s.kind == "train":
                args.append(dr.Placed(p["opt"], sharding.tree_param_specs(
                    p["opt"])))
            if s.kind == "decode":
                args.append(dr.Placed(p["caches"][n], dr.cache_shardings(
                    p["caches"][n], mesh)))
            out[f"{n}/{cim}"] = sum(dr.per_chip_bytes(a) for a in args)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placement(arch, ref):
    p = port_trees(arch)
    for mesh_kind in ("single", "multi"):
        mesh = PlannedMesh(dr.PRODUCTION_MESHES[mesh_kind])
        for fsdp in (True, False):
            r = ref["placed"][arch][
                f"{mesh_kind}-{'fsdp' if fsdp else 'nofsdp'}"]
            sharding.set_mesh(mesh)
            sharding.set_fsdp(fsdp)
            try:
                for name in ("params", "quantized"):
                    assert _specs(p[name], dr.params_shardings(
                        p[name], mesh)) == r[name], (name, fsdp)
                assert _specs(p["opt"], sharding.tree_param_specs(
                    p["opt"])) == r["opt"]
                for n, b in p["inputs"].items():
                    assert _specs(b, dr.batch_shardings(b, mesh)) == \
                        r["inputs"][n], n
                for n, c in p["caches"].items():
                    assert _specs(c, dr.cache_shardings(c, mesh)) == \
                        r["caches"][n], n
                assert _port_bytes(p, arch, mesh) == r["bytes"]
            finally:
                sharding.set_mesh(None)
                sharding.set_fsdp(True)


@pytest.mark.parametrize("shape,cim", [("decode_32k", "bp-prequant"),
                                       ("train_4k", "off")])
def test_build_cell_bytes(shape, cim, ref):
    """build_cell's arguments on the planned mesh: the reference's bytes
    (internlm2-1.8b at full width)."""
    mesh = PlannedMesh(dr.PRODUCTION_MESHES["single"])
    sharding.set_mesh(mesh)
    try:
        _, args, _, _ = dr.build_cell("internlm2-1.8b", shape, mesh,
                                      cim=cim)
        got = sum(dr.per_chip_bytes(a) for a in args)
    finally:
        sharding.set_mesh(None)
    assert got == ref["placed"]["internlm2-1.8b"]["single-fsdp"][
        "bytes"][f"{shape}/{cim}"]


# ---------------------------------------------------------------------------
# (e) recorded collectives: a planned 2 x 2 mesh against real gloo ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", ["internlm2", "qwen2_moe_a2a", "pipeline"])
def test_collectives_planned_vs_gloo(step, gloo_records):
    sys.path.insert(0, HERE)
    import _torch_mesh_worker as worker
    sharding.set_mesh(PlannedMesh({"data": 2, "model": 2}))
    try:
        with hlo.recording() as rec, torch.no_grad():
            if step == "pipeline":
                worker.dryrun_pipeline("meta")
            else:
                cfg, b, max_len = worker.dryrun_step_cfg(step)
                params = abstract_quantized_params(
                    registry.abstract_params(cfg, max_seq=max_len), cfg)
                mod = registry.get_module(cfg)
                cache = mod.init_cache(cfg, b, max_len, device="meta")
                tokens = torch.empty((b, 1), dtype=torch.int32,
                                     device="meta")
                mod.decode_step(params, tokens, cache, cfg)
    finally:
        sharding.set_mesh(None)
    kinds = [hlo.COLLECTIVES.index(k) for k, _ in rec.collectives]
    nbytes = [n for _, n in rec.collectives]
    real = gloo_records[0]
    assert kinds == real[f"{step}_kinds"].tolist()
    assert nbytes == real[f"{step}_bytes"].tolist()
    assert len(kinds) > 0
    if step == "qwen2_moe_a2a":
        assert hlo.COLLECTIVES.index("all-to-all") in kinds
    if step == "pipeline":      # 4 ticks' hops, then the broadcast
        assert kinds == [hlo.COLLECTIVES.index("collective-permute")] * 5
        want = torch.ones(3, 2, 8) @ torch.ones(8, 8) @ torch.ones(8, 8)
        for r in gloo_records:
            assert torch.equal(torch.from_numpy(r["pipeline_y"]), want)
    for r in gloo_records[1:]:          # every rank issues the same calls
        assert r[f"{step}_kinds"].tolist() == kinds


# torch.distributed's calls that move data: only `parallel.sharding`'s
# recorded helpers may make them
_DIST_CALLS = ("all_gather", "all_gather_into_tensor", "all_gather_object",
               "all_reduce", "reduce", "reduce_scatter",
               "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
               "broadcast", "broadcast_object_list", "scatter", "gather",
               "send", "recv", "isend", "irecv", "batch_isend_irecv",
               "P2POp")


def test_every_collective_is_recorded():
    """Every collective of the port goes through the helpers that record
    it, so the dry-run's accounting (test above) sees every call site."""
    import re
    call = re.compile(r"\b(?:dist|torch\.distributed)\.(%s)\b"
                      % "|".join(_DIST_CALLS))
    imp = re.compile(r"from torch\.distributed(?:\.\w+)* import|"
                     r"_functional_collectives|\bfuncol\b")
    src = os.path.join(ROOT, "src", "repro_torch")
    found = {}
    for d, _, files in os.walk(src):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            rel = os.path.relpath(path, src)
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    code = line.split("#")[0]
                    for m in call.finditer(code):
                        found.setdefault(rel, []).append((i, m.group(1)))
                    if imp.search(code) and "init_device_mesh" not in code:
                        found.setdefault(rel, []).append((i, "import"))
    assert set(found) == {os.path.join("parallel", "sharding.py")}, found
    with open(os.path.join(src, "parallel", "sharding.py")) as fh:
        lines = fh.read().splitlines()
    helpers = lines.index("def group_size(group) -> int:")
    assert all(i > helpers for i, _ in found["parallel/sharding.py"]), \
        found
    assert {n for _, n in found["parallel/sharding.py"]} == {
        "all_gather", "reduce_scatter_tensor", "all_to_all_single",
        "all_reduce", "P2POp", "isend", "irecv", "batch_isend_irecv",
        "broadcast"}


# ---------------------------------------------------------------------------
# (f) run_cell: JSON, cell ids, skips
# ---------------------------------------------------------------------------
def test_run_cell_keys(ref, tmp_path):
    r = dr.run_cell("internlm2-1.8b", "decode_32k", "single",
                    cfg_override=SMOKES["internlm2-1.8b"],
                    out_dir=str(tmp_path))
    ok = ref["cells"]["ok"]
    assert r["status"] == ok["status"] == "ok", r.get("error")
    assert r["cell"] == ok["cell"]
    # the reference's keys, and what the traced program was
    assert sorted(r) == sorted(ok["keys"] + ["program"])
    assert sorted(r["roofline"]) == sorted(ok["roofline_keys"]
                                           + ["work_chips"])
    assert r["program"] == "rank0-whole-tensors"
    assert r["roofline"]["work_chips"] == 1
    # no generated code: every other memory key of the reference's
    assert sorted(r["memory_analysis"]) == \
        [k for k in ok["memory_keys"] if k != "generated_code_size_in_bytes"]
    assert r["roofline"]["chips"] == 256
    with open(tmp_path / (r["cell"] + ".json")) as f:
        assert json.load(f) == r
    mem = r["memory_analysis"]
    assert mem["peak_memory_in_bytes"] == \
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert mem["alias_size_in_bytes"] > 0      # the cache, written in place
    assert dr.status_line(r).startswith("[ok     ] internlm2-1.8b__")


@pytest.mark.parametrize("name", ["long", "prequant_train", "ep_dense",
                                  "xp_long"])
def test_run_cell_skips(name, ref):
    want = ref["cells"][name]
    kw = {k: want[k] for k in ("cim", "ep") if k in want}
    if want["cell"].endswith("__xp"):
        kw["analysis"] = "extrapolate"
    mesh = {"pod16x16": "single", "pod2x16x16": "multi"}[want["mesh"]]
    got = dr.run_cell(want["arch"], want["shape"], mesh, **kw)
    assert got == want




@pytest.mark.parametrize("arch,program", [
    ("internlm2-1.8b", "rank0-sharded-state"),
    ("qwen2-moe-a2.7b", "rank0-partitioned")])
def test_train_cell_runs_on_the_placed_state(arch, program):
    """A train cell on the planned mesh runs rank 0's step on the state
    as the Trainer places it: the blocks' bytes plus the batch's plan are
    the cell's argument bytes. The dense --cim off step's only
    collectives move the state (each layer's gather, the optimizer's
    sums): "rank0-sharded-state", work_chips 1, and the traced FLOPs (so
    the useful ratio) are those of the same step on the whole state, the
    parent's program. The MoE step's expert slices split work:
    "rank0-partitioned" over the mesh's chips, the state's gathers
    counted beside."""
    from repro_torch.optim.optimizers import tree_leaves
    cfg = _smoke(arch)
    mesh = PlannedMesh(dr.PRODUCTION_MESHES["single"])
    sharding.set_mesh(mesh)
    try:
        step, (state, batch), cfg2, _ = dr.build_cell(
            arch, "train_4k", mesh, cfg_override=cfg)
        assert state.blocks is not None
        resident = sum(t.numel() * t.element_size()
                       for t in tree_leaves(state.blocks))
        planned = dr.per_chip_bytes(state)
        batch_bytes = dr.per_chip_bytes(batch)
        whole_step, _ = make_train_step(cfg2, TrainConfig(
            optimizer=dr.choose_optimizer(state.tree["params"])))
        whole = dr.trace_step(whole_step, (state.tree, batch.tree),
                              train=True)
    finally:
        sharding.set_mesh(None)
    assert resident == planned
    assert resident < sum(t.numel() * t.element_size()
                          for t in tree_leaves(state.tree)) // 16
    r = dr.run_cell(arch, "train_4k", "single", cfg_override=cfg)
    assert r["status"] == "ok", r.get("error")
    assert r["memory_analysis"]["argument_size_in_bytes"] == \
        resident + batch_bytes
    assert r["program"] == program
    rl = r["roofline"]
    state_bytes = rl["collective_detail"]["state_bytes"]
    assert state_bytes > 0
    assert rl["collective_detail"]["counts"]["all-gather"] > 0
    assert rl["hlo_flops"] == whole.flops
    if program == "rank0-sharded-state":
        assert rl["work_chips"] == 1
        assert rl["collective_bytes"] == state_bytes
        assert not whole.collectives.count_by_kind
    else:
        assert rl["work_chips"] == 256
        assert rl["collective_bytes"] > state_bytes
    assert rl["useful_ratio"] == pytest.approx(
        rl["model_flops"] / rl["work_chips"] / rl["hlo_flops"], rel=1e-12)
