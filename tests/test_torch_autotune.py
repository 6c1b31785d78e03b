"""kernels.autotune of the port against the reference's contract
(tests/test_autotune.py, test for test): the cache round-trip into both
dispatchers (B3's split S in the paged-attention dispatchers, the MVM
kernels' cluster size and column warps in kernels.ops), shape-family
bucketing, platform keys ("cpu" / "sm_90"), the port's backend names, and
the malformed / stale cache fallbacks. On the CPU the kernel backends run
their plain versions, which take the same S; the MVM knobs change no bit
and reach the CUDA launchers only on the card (tests/test_torch_gpu.py)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

from repro_torch.core.cim_matmul import (CIMConfig, cim_matmul,
                                         cim_matmul_prequant,
                                         quantize_weight_offline)
from repro_torch.core.macro import MacroConfig
from repro_torch.kernels import autotune, cim_mvm, ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.runtime.telemetry import KERNEL_COUNTERS

from test_torch_paged_attention import TOL, _case, _positions, _torch


@pytest.fixture(autouse=True)
def _fresh_counters():
    KERNEL_COUNTERS.reset()
    yield
    KERNEL_COUNTERS.reset()


def _write_cache(path, entries):
    doc = autotune.save_cache(str(path), entries, platform="cpu")
    assert doc["schema"] == autotune.CACHE_SCHEMA
    assert doc["torch"] == torch.__version__
    return str(path)


def _tables(mb, b=2):
    return torch.zeros((b, mb), dtype=torch.int32)


# ---------------------------------------------------------------------------
# shape families
# ---------------------------------------------------------------------------
def test_shape_families_bucket():
    assert autotune.attn_family(4096, 1) == "decode_w4096"
    assert autotune.attn_family(40, 1) == "decode_w64"    # rounds up
    assert autotune.attn_family(256, 8) == "prefill_w256"
    assert autotune.mvm_family(32, 4, 128) == "m32_g4_n128"
    assert autotune.mvm_family(33, 4, 128) == "m64_g4_n128"


def test_cache_key_includes_platform():
    k = autotune.cache_key("paged_attn", "decode_w64", "kernel")
    assert k.endswith("|cpu")
    assert autotune.platform_of("cpu") == "cpu"
    assert autotune.platform_of(torch.zeros(1).device) == "cpu"
    assert autotune.cache_key("a", "b", "c", "sm_90") == "a|b|c|sm_90"


# ---------------------------------------------------------------------------
# round-trip: write → reload → dispatch picks the tuned config
# ---------------------------------------------------------------------------
def test_attn_dispatch_picks_tuned_config(tmp_path, monkeypatch):
    path = _write_cache(tmp_path / "tc.json", {
        autotune.cache_key("paged_attn", "decode_w64", "kernel"):
            {"splits": 4, "block_size": None},
    })
    monkeypatch.setenv(autotune.CACHE_ENV, path)
    # MB 5 x bs 8 = window 40 buckets to w64 → tuned hit
    assert pa.resolve_splits(_tables(5), 1, 8) == 4
    # the prefill family has no entry → the default min(8, MB)
    assert pa.resolve_splits(_tables(5), 8, 8) == 5
    assert dict(KERNEL_COUNTERS.tune_cache) == {"paged_attn:hit": 1,
                                                "paged_attn:miss": 1}


def test_attn_tuned_config_clamped_to_geometry(tmp_path, monkeypatch):
    path = _write_cache(tmp_path / "tc.json", {
        autotune.cache_key("paged_attn", "decode_w64", "kernel"):
            {"splits": 64},
    })
    monkeypatch.setenv(autotune.CACHE_ENV, path)
    assert pa.resolve_splits(_tables(3), 1, 16) == 3       # S <= MB
    assert pa.resolve_splits(_tables(16), 1, 4) == 8       # S <= 8
    assert KERNEL_COUNTERS.tune_cache["paged_attn:clamp"] == 2


def test_mvm_dispatch_picks_tuned_knobs(tmp_path, monkeypatch):
    cfg = MacroConfig()
    x = torch.zeros((8, 288))
    fam = autotune.mvm_family(8, 2, 64)
    path = _write_cache(tmp_path / "tc.json", {
        autotune.cache_key("cim_mvm", fam, "cuda_packed"):
            {"cluster": 2, "wcols": 4},
    })
    monkeypatch.setenv(autotune.CACHE_ENV, path)
    assert ops._resolve_knobs("cuda_packed", x, 64, cfg, None, None) == \
        {"cluster": 2, "wcols": 4}
    # explicit kwargs always win over the cache
    assert ops._resolve_knobs("cuda_packed", x, 64, cfg, 1, 1) == \
        {"cluster": 1, "wcols": 1}
    # another backend's key, or another shape family, misses → 0, 0
    assert ops._resolve_knobs("cuda", x, 64, cfg, None, None) == \
        {"cluster": 0, "wcols": 0}
    assert ops._resolve_knobs("cuda_packed", torch.zeros((8, 144)), 64, cfg,
                              None, None) == {"cluster": 0, "wcols": 0}
    # values the geometry cannot take go to the launcher as they are: it
    # clamps them (cluster <= min(8, G); column warps a power of two up
    # to 8) and reports what it launched, and the wrapper counts each
    # such launch once
    assert ops._resolve_knobs("cuda_packed", x, 64, cfg, 8, 6) == \
        {"cluster": 8, "wcols": 6}
    assert ops._resolve_knobs("cuda_packed", x, 64, cfg, 1, 16) == \
        {"cluster": 1, "wcols": 16}
    assert KERNEL_COUNTERS.tune_cache.get("cim_mvm:clamp", 0) == 0
    for asked, launched in (((8, 6), (2, 4)), ((1, 16), (1, 8)),
                            ((2, 4), (2, 4)), ((0, 4), (3, 4))):
        knobs = cim_mvm._knob_args(*asked)
        knobs[2][0], knobs[2][1] = launched
        cim_mvm._count_clamp(knobs)
    assert KERNEL_COUNTERS.tune_cache["cim_mvm:clamp"] == 2


def test_platform_mismatch_is_a_miss(tmp_path, monkeypatch):
    path = _write_cache(tmp_path / "tc.json", {
        autotune.cache_key("paged_attn", "decode_w64", "kernel",
                           platform="sm_90"): {"splits": 2},
    })
    monkeypatch.setenv(autotune.CACHE_ENV, path)
    assert pa.resolve_splits(_tables(8), 1, 8) == 8
    assert dict(KERNEL_COUNTERS.tune_cache) == {"paged_attn:miss": 1}


def test_cache_reloads_on_rewrite(tmp_path, monkeypatch):
    """A freshly rewritten cache file is picked up without restarting."""
    key = autotune.cache_key("paged_attn", "decode_w64", "kernel")
    path = _write_cache(tmp_path / "tc.json", {key: {"splits": 2}})
    monkeypatch.setenv(autotune.CACHE_ENV, path)
    assert pa.resolve_splits(_tables(8), 1, 8) == 2
    os.utime(_write_cache(tmp_path / "tc.json", {key: {"splits": 6}}),
             (1e9, 1e9))  # force a distinct mtime even on coarse clocks
    assert pa.resolve_splits(_tables(8), 1, 8) == 6


def test_outside_rewrite_seen_after_the_recheck_interval(tmp_path,
                                                         monkeypatch):
    """A rewrite by another writer is read once RECHECK_S has passed (the
    dispatchers look up once per MVM, so the file is not stat'ed each
    time); save_cache's own writes are read at once."""
    clock = [100.0]
    monkeypatch.setattr(autotune, "time",
                        type("T", (), {"monotonic": lambda: clock[0]}))
    key = autotune.cache_key("paged_attn", "decode_w64", "kernel")
    path = _write_cache(tmp_path / "tc.json", {key: {"splits": 2}})
    monkeypatch.setenv(autotune.CACHE_ENV, path)
    assert pa.resolve_splits(_tables(8), 1, 8) == 2
    with open(path, "w") as f:                      # another writer
        json.dump({"schema": autotune.CACHE_SCHEMA,
                   "entries": {key: {"splits": 5}}}, f)
    os.utime(path, (1e9, 1e9))
    assert pa.resolve_splits(_tables(8), 1, 8) == 2      # not yet
    clock[0] += autotune.RECHECK_S
    assert pa.resolve_splits(_tables(8), 1, 8) == 5


@pytest.mark.parametrize("splits", [1, 3])
def test_tuned_attn_end_to_end_matches_exact(tmp_path, monkeypatch, splits):
    """The full dispatch chain under a tuned cache: paged_attention with
    backend "kernel" runs at the tuned S (on the CPU its plain version),
    bit for bit as paged_attn_plain at that S, and still matches exact."""
    q, kp, vp, tables, lens, kvl = case = _case(61, mb=8, c=1)
    tq, tk, tv, tt, tl, tkvl = _torch(case)
    pos = torch.from_numpy(_positions(lens, 1))
    o_ref = pa.paged_attention(tq, tk, tv, tt, positions=pos, kv_len=tkvl,
                               backend="exact").numpy()
    path = _write_cache(tmp_path / "tc.json", {
        autotune.cache_key("paged_attn", "decode_w64", "kernel"):
            {"splits": splits},
    })
    monkeypatch.setenv(autotune.CACHE_ENV, path)
    o = pa.paged_attention(tq, tk, tv, tt, positions=pos, kv_len=tkvl,
                           backend="kernel").numpy()
    at_s = pa.paged_attn_plain(tq, tk, tv, tt, tl, tkvl, splits).numpy()
    assert np.array_equal(o, at_s)
    np.testing.assert_allclose(o, o_ref, **TOL)


# ---------------------------------------------------------------------------
# malformed / stale caches degrade to defaults, never error
# ---------------------------------------------------------------------------
def test_missing_cache_file_is_empty(monkeypatch):
    monkeypatch.setenv(autotune.CACHE_ENV, "/nonexistent/tune.json")
    assert autotune.load_cache() == {}
    assert pa.resolve_splits(_tables(8), 1, 8) == 8


def test_no_env_is_empty(monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    assert autotune.load_cache() == {}
    assert pa.resolve_splits(_tables(8), 1, 8) == 8
    assert dict(KERNEL_COUNTERS.tune_cache) == {}      # no lookup counted


def test_malformed_json_falls_back(tmp_path, monkeypatch):
    p = tmp_path / "bad.json"
    p.write_text("{not json")
    monkeypatch.setenv(autotune.CACHE_ENV, str(p))
    with pytest.warns(UserWarning, match="ignoring tune cache"):
        assert autotune.load_cache() == {}
    assert pa.resolve_splits(_tables(8), 1, 8) == 8     # no second warning
    assert KERNEL_COUNTERS.fallback_warnings == 1


def test_stale_schema_falls_back(tmp_path, monkeypatch):
    p = tmp_path / "stale.json"
    p.write_text(json.dumps({"schema": "pico-ram/tune_cache/v0",
                             "entries": {"x": {"splits": 8}}}))
    monkeypatch.setenv(autotune.CACHE_ENV, str(p))
    with pytest.warns(UserWarning, match="schema"):
        assert autotune.load_cache() == {}
    assert KERNEL_COUNTERS.fallback_warnings == 1


def test_non_dict_entries_dropped(tmp_path, monkeypatch):
    p = tmp_path / "odd.json"
    p.write_text(json.dumps({"schema": autotune.CACHE_SCHEMA,
                             "entries": {"a": [1, 2], "b": {"cluster": 2}}}))
    monkeypatch.setenv(autotune.CACHE_ENV, str(p))
    assert autotune.load_cache() == {"b": {"cluster": 2}}


# ---------------------------------------------------------------------------
# candidate enumeration (what chip_smoke.py's phase "tune" times)
# ---------------------------------------------------------------------------
def test_attn_candidates_default_first():
    cands = autotune.attn_candidates(16)
    assert cands[0] == {"splits": 8, "block_size": None}
    assert sorted(c["splits"] for c in cands) == list(range(1, 9))
    assert [c["splits"] for c in autotune.attn_candidates(3)] == [3, 1, 2]


def test_attn_candidates_block_size_axis():
    """Stating the pool's pagination adds coarser-block layout candidates
    (consumed by serve.py, not the dispatcher); the default stays first."""
    cands = autotune.attn_candidates(256, block_size=16)
    assert cands[0] == {"splits": 8, "block_size": 16}
    assert {16, 64, 128} <= {c["block_size"] for c in cands}
    # mb=6 is not divisible by 4 or 8 → no coarser layouts proposed
    assert all(c["block_size"] == 8
               for c in autotune.attn_candidates(6, block_size=8))


def test_mvm_candidates_default_first():
    cands = autotune.mvm_candidates(15)
    assert cands[0] == {"cluster": 0, "wcols": 0}
    assert {c["cluster"] for c in cands} == {0, 1, 2, 4, 8}
    assert {c["wcols"] for c in cands} == {0, 1, 2, 4, 8}
    assert all(c["cluster"] <= 1 for c in autotune.mvm_candidates(1))


# ---------------------------------------------------------------------------
# the port's keys against the reference's cache, and both backends
# ---------------------------------------------------------------------------
def test_reference_written_cache_misses(tmp_path, monkeypatch):
    """A cache the reference wrote (backend "pallas", its tiles and
    kblocks) is never a wrong hit: the MVM lookups miss, and an attention
    entry without `splits` leaves B3's default S."""
    from repro.kernels import autotune as ref_autotune
    path = str(tmp_path / "ref.json")
    ref_autotune.save_cache(path, {
        ref_autotune.cache_key("cim_mvm", "m8_g4_n64", "pallas", "cpu"):
            {"bm": 32, "bn": 64},
        ref_autotune.cache_key("cim_mvm", "m8_g4_n64", "pallas_packed",
                               "cpu"): {"bm": 32, "bn": 64},
        ref_autotune.cache_key("paged_attn", "decode_w64", "kernel", "cpu"):
            {"kblocks": 4, "row_tile": None},
    })
    monkeypatch.setenv(autotune.CACHE_ENV, path)
    cfg = MacroConfig()
    x = torch.zeros((8, 576))
    for backend in ("cuda", "cuda_packed"):
        assert ops._resolve_knobs(backend, x, 64, cfg, None, None) == \
            {"cluster": 0, "wcols": 0}
    assert KERNEL_COUNTERS.tune_cache["cim_mvm:miss"] == 2
    assert pa.resolve_splits(_tables(8), 1, 8) == 8


def test_knob_lookups_reach_both_backends(tmp_path, monkeypatch):
    """The MVM knobs reach the dense and the packed kernel backend
    through the engine (hits counted, outputs unchanged); B3's S reaches
    the kernel and the plain attention backend, on the prefill dispatcher
    and on the decode route (models.common), both at the tuned S."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.standard_normal((8, 576)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((576, 64)) * 0.1)
                         .astype(np.float32))
    cfg = CIMConfig(enabled=True)
    codes, s_w = quantize_weight_offline(w, cfg)
    packed = ops.pack_codes(codes)
    base = (cim_matmul(x, w, cfg), cim_matmul_prequant(x, packed, s_w, cfg))
    fam = autotune.mvm_family(8, 4, 64)
    q, kp, vp, tables, lens, kvl = case = _case(5, mb=8, c=1)
    path = _write_cache(tmp_path / "tc.json", {
        autotune.cache_key("cim_mvm", fam, "cuda"): {"cluster": 4,
                                                     "wcols": 2},
        autotune.cache_key("cim_mvm", fam, "cuda_packed"): {"cluster": 2},
        autotune.cache_key("paged_attn", "decode_w64", "kernel"):
            {"splits": 3},
    })
    monkeypatch.setenv(autotune.CACHE_ENV, path)
    tuned = (cim_matmul(x, w, cfg), cim_matmul_prequant(x, packed, s_w, cfg))
    assert all(torch.equal(a, b) for a, b in zip(base, tuned))
    assert KERNEL_COUNTERS.tune_cache["cim_mvm:hit"] == 2
    assert KERNEL_COUNTERS.tune_cache.get("cim_mvm:clamp", 0) == 0

    tq, tk, tv, tt, tl, tkvl = _torch(case)
    pos = torch.from_numpy(_positions(lens, 1))
    at_s = pa.paged_attn_plain(tq, tk, tv, tt, tl, tkvl, 3)
    for backend in ("kernel", "plain"):
        o = pa.paged_attention(tq, tk, tv, tt, positions=pos, kv_len=tkvl,
                               backend=backend)
        assert torch.equal(o, at_s), backend
    assert KERNEL_COUNTERS.tune_cache["paged_attn:hit"] == 2

    from repro_torch.configs.registry import SMOKES
    from repro_torch.models import registry, transformer
    for backend in ("kernel", "plain"):
        mcfg = SMOKES["internlm2-1.8b"].replace(dtype="float32",
                                                attn_backend=backend)
        params = registry.init_params(mcfg, seed=0, device="cpu")
        cache = transformer.init_paged_cache(mcfg, 9, 8, device="cpu")
        tables_ = torch.arange(1, 9, dtype=torch.int32).reshape(1, 8)
        before = KERNEL_COUNTERS.tune_cache["paged_attn:hit"]
        transformer.paged_step(params, torch.tensor([[1]]), cache, tables_,
                               torch.tensor([3]), torch.tensor([1]), mcfg)
        assert KERNEL_COUNTERS.tune_cache["paged_attn:hit"] - before == \
            mcfg.n_layers, backend


def test_mvm_knobs_leave_every_backend_bit_identical():
    """Explicit knobs on every entry of kernels.ops (the CPU runs the
    plain versions): the same bits as without, at IDEAL and NOISY,
    packed and dense, 2-D and expert-batched."""
    rng = np.random.RandomState(4)
    cfg = MacroConfig()
    noisy = dataclasses.replace(cfg, sim_level=cfg.sim_level.NOISY)
    x = torch.from_numpy(rng.randint(0, 16, (4, 300)).astype(np.float32))
    w = torch.from_numpy(rng.randint(0, 16, (300, 24)).astype(np.float32))
    xe, we = x.reshape(2, 2, 300), torch.stack([w, w.flip(0)])
    seed = torch.tensor([7], dtype=torch.int32)
    calls = [
        (ops.cim_mvm_dense, (x, w, cfg), {}),
        (ops.cim_mvm_packed, (x, ops.pack_codes(w), cfg), {}),
        (ops.cim_mvm_dense_experts, (xe, we, cfg), {}),
        (ops.cim_mvm_packed_experts, (xe, ops.pack_codes(we), cfg), {}),
        (ops.cim_mvm_noisy, (x, w, noisy), {"noise_seed": seed}),
        (ops.cim_mvm_noisy_packed, (x, ops.pack_codes(w), noisy),
         {"noise_seed": seed}),
        (ops.cim_mvm_noisy_experts, (xe, we, noisy), {"noise_seed": seed}),
        (ops.cim_mvm_noisy_packed_experts, (xe, ops.pack_codes(we), noisy),
         {"noise_seed": seed}),
    ]
    for fn, args, kw in calls:
        y0 = fn(*args, **kw)
        for cluster, wcols in ((1, 1), (3, 8), (2, 2)):
            assert torch.equal(fn(*args, **kw, cluster=cluster,
                                  wcols=wcols), y0), fn.__name__
