"""The port's paged Server against the reference Server, plus the port's
import and device contracts.

Greedy token streams must EQUAL the reference's on the reference's own
smoke schedules (mixed-depth admission, preemption with trie resume, a
prefix hit), in the float32 model, on the same weights carried across by
`params_from_numpy`; the scheduler metrics must agree too. Legs: no CIM
with the exact attention; nibble-packed prequant (B1) with the kernel
attention; and the seeded NOISY converter chain (noise_seed 0, as
`serve.py --cim bp-noisy` builds it) with weights quantized on the fly
(B5) and with nibble-packed prequant weights (B6). A block size of 64
(B3 scores it in pieces of 32 tokens) and `eos_id` retirement at prefill
and at decode are held to the reference too.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_helpers import to_numpy_tree

from repro_torch.configs.registry import SMOKES
from repro_torch.core.cim_matmul import CIMConfig
from repro_torch.models import registry
from repro_torch.runtime import server as tserver

REPO = os.path.join(os.path.dirname(__file__), "..")
MAX_LEN = 64
LEGS = {"off-exact": ("off", "exact"),
        "prequant-kernel": ("bp-prequant", "kernel"),
        "bp-noisy": ("bp-noisy", "kernel"),
        "noisy-prequant": ("noisy-prequant", "kernel")}


def _noisy(cim_cls, level_cls):
    """CIMConfig at NOISY with noise_seed 0, built as serve.py builds it."""
    cim = cim_cls(enabled=True, noise_seed=0)
    return dataclasses.replace(cim, macro=dataclasses.replace(
        cim.macro, sim_level=level_cls.NOISY))


@pytest.fixture(scope="module")
def ref_weights():
    jax = pytest.importorskip("jax")
    from repro.configs.registry import SMOKES as REF_SMOKES
    from repro.models import registry as ref_registry
    cfg = REF_SMOKES["internlm2-1.8b"].replace(dtype="float32")
    params = ref_registry.init_params(jax.random.PRNGKey(0), cfg,
                                      max_seq=MAX_LEN)
    return params, to_numpy_tree(params)


def _servers(ref_weights, leg, **kw):
    from repro.configs.registry import SMOKES as REF_SMOKES
    from repro.core.cim_matmul import CIMConfig as RefCIM
    from repro.core.macro import SimLevel as RefLevel
    from repro.runtime import server as rserver
    from repro_torch.core.macro import SimLevel
    cim, attn = LEGS[leg]
    rcfg = REF_SMOKES["internlm2-1.8b"].replace(dtype="float32")
    tcfg = SMOKES["internlm2-1.8b"].replace(dtype="float32")
    if cim in ("bp-noisy", "noisy-prequant"):
        rcfg = rcfg.replace(cim=_noisy(RefCIM, RefLevel))
        tcfg = tcfg.replace(cim=_noisy(CIMConfig, SimLevel))
    elif cim != "off":
        rcfg = rcfg.replace(cim=RefCIM(enabled=True))
        tcfg = tcfg.replace(cim=CIMConfig(enabled=True))
    kw = dict(dict(n_slots=2, max_len=MAX_LEN, block_size=8,
                   prefill_chunk=4, attn=attn,
                   prequant=cim in ("bp-prequant", "noisy-prequant")), **kw)
    ref = rserver.Server(ref_weights[0], rcfg,
                         rserver.ServingConfig(paged=True, telemetry=False,
                                               **kw))
    port = tserver.Server(
        registry.params_from_numpy(ref_weights[1], tcfg, device="cpu"), tcfg,
        tserver.ServingConfig(**kw), device="cpu")
    return (ref, rserver.Request), (port, tserver.Request)


METRICS = ("steps", "decode_tokens", "prefill_tokens", "preemptions",
           "prefix_hit_tokens", "cow_forks", "stalled_prefills",
           "stalled_decodes")


def _same_metrics(ref, port):
    r, t = ref.metrics.summary(), port.metrics.summary()
    assert {k: r[k] for k in METRICS} == {k: t[k] for k in METRICS}


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_mixed_depth_schedule_matches_reference(ref_weights, leg):
    outs = []
    for srv, Req in _servers(ref_weights, leg):
        rng = np.random.RandomState(42)
        schedule = {0: 2, 2: 1, 3: 1, 7: 1}
        reqs, step = [], 0
        while reqs == [] or any(not r.done for r in reqs) or srv.queue:
            for _ in range(schedule.get(step, 0)):
                plen = int(rng.randint(3, 9))
                r = Req(prompt=rng.randint(0, 512, size=plen).tolist(),
                        max_new_tokens=int(rng.randint(2, 6)))
                srv.submit(r)
                reqs.append(r)
            srv.step()
            step += 1
            assert step < 200
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


# The NOISY legs are not held to the jitted reference on this schedule: at
# its step 8 the reference's jitted step and its own eager step differ by a
# whole ADC step (layer 1's K of the resumed lane moves by 3.07; the jit
# rounds some f32 op differently and a DAC code flips, ROADMAP Queue C).
# The port there agrees with the eager reference to 2.4e-7 and emits its
# token.
@pytest.mark.parametrize("leg", ["off-exact", "prequant-kernel"])
def test_preemption_schedule_matches_reference(ref_weights, leg):
    (ref, RReq), (port, TReq) = _servers(
        ref_weights, leg, n_slots=3, num_blocks=5, watermark=0.0,
        token_budget=32)
    outs = []
    for srv, Req in ((ref, RReq), (port, TReq)):
        rng = np.random.RandomState(29)
        reqs = [Req(prompt=rng.randint(0, 512, size=9).tolist(),
                    max_new_tokens=6) for _ in range(3)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert port.metrics.preemptions > 0
    _same_metrics(ref, port)
    port.flush_prefix_cache()
    assert port.alloc.stats.in_use == 0


def test_block_size_64_matches_reference(ref_weights):
    """Blocks of 64 tokens under the kernel attention: prompts of 20-90
    tokens span both pieces of a block and a second block."""
    (ref, RReq), (port, TReq) = _servers(
        ref_weights, "prequant-kernel", block_size=64, max_len=128,
        prefill_chunk=16)
    outs = []
    for srv, Req in ((ref, RReq), (port, TReq)):
        rng = np.random.RandomState(64)
        reqs = [Req(prompt=rng.randint(0, 512, size=n).tolist(),
                    max_new_tokens=int(rng.randint(3, 7)))
                for n in (90, 20, 45, 70)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert max(len(r.prompt) + len(r.output) for r in reqs) > 64
    _same_metrics(ref, port)


@pytest.mark.parametrize("where", ["prefill", "decode"])
@pytest.mark.parametrize("leg", ["off-exact", "prequant-kernel"])
def test_eos_retirement_matches_reference(ref_weights, leg, where):
    """eos_id taken from the reference Server's own greedy stream at a
    step whose token did not occur earlier in it (the first token for a
    prefill-time EOS): the reference and the port both retire there, with
    the same stream."""
    (ref, RReq), (port, TReq) = _servers(ref_weights, leg)
    prompt = np.random.RandomState(5).randint(0, 512, size=5).tolist()
    free = RReq(prompt=list(prompt), max_new_tokens=8)
    ref.submit(free)
    ref.run_until_drained()
    stream = free.output
    if where == "prefill":
        i = 0
    else:
        i = next(i for i in range(2, len(stream))
                 if stream[i] not in stream[:i])
    outs = []
    for srv, Req in ((ref, RReq), (port, TReq)):
        r = Req(prompt=list(prompt), max_new_tokens=8, eos_id=stream[i])
        srv.submit(r)
        srv.run_until_drained()
        assert r.done
        outs.append(r.output)
    assert outs[0] == outs[1] == stream[:i + 1]
    port.flush_prefix_cache()
    assert port.alloc.stats.in_use == 0


def test_prefix_hit_schedule_matches_reference(ref_weights):
    (ref, RReq), (port, TReq) = _servers(ref_weights, "prequant-kernel")
    outs = []
    for srv, Req in ((ref, RReq), (port, TReq)):
        rng = np.random.RandomState(21)
        prefix = rng.randint(0, 512, size=16).tolist()
        warm = Req(prompt=prefix + [7, 7], max_new_tokens=3)
        srv.submit(warm)
        srv.run_until_drained()
        follower = Req(prompt=prefix + [3, 1, 4], max_new_tokens=4)
        srv.submit(follower)
        srv.run_until_drained()
        outs.append([warm.output, follower.output])
    assert outs[0] == outs[1]
    assert port.metrics.prefix_hit_tokens == 16
    _same_metrics(ref, port)


# ---------------------------------------------------------------------------
# contracts that need no reference
# ---------------------------------------------------------------------------
def test_port_imports_no_jax_and_no_reference():
    code = (
        "import sys, pkgutil, importlib\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for m in ('repro_torch.core.adc', 'repro_torch.core.engine',\n"
        "          'repro_torch.kernels.cim_mvm', 'repro_torch.kernels.ops',\n"
        "          'repro_torch.runtime.telemetry', 'repro_torch.runtime.obs',\n"
        "          'repro_torch.core.energy'):\n"
        "    assert m in sys.modules, m\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), REPO]))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _smoke_params():
    cfg = SMOKES["internlm2-1.8b"]
    return cfg, registry.init_params(cfg, seed=0, device="cpu")


def test_entry_points_without_device_raise_on_cpu_only_machine():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, params = _smoke_params()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserver.Server(params, cfg)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--requests", "1"])


@pytest.mark.parametrize("field,value,item", [
    ("paged", False, "A4e"),
    ("act_scale", 0.1, "A7"), ("precision_manifest", "m.json", "A7")])
def test_serving_config_unported_options_raise(field, value, item):
    with pytest.raises(NotImplementedError, match=item):
        tserver.ServingConfig(**{field: value})


def test_model_drafter_not_ported():
    from repro_torch.runtime.speculative import make_drafter
    cfg, _ = _smoke_params()
    with pytest.raises(NotImplementedError, match="A4e"):
        make_drafter("model:internlm2-1.8b", cfg, 64)


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--smoke", "--requests", "2", "--max-new", "3",
                "--cim", "bp-prequant", "--attn", "kernel",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("req") >= 2 and "tok/s" in out
