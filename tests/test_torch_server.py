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
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

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
        tserver.ServingConfig(paged=True, **kw), device="cpu")
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


@pytest.mark.parametrize("engine", ["paged", "slots"])
@pytest.mark.parametrize("arch", ["stablelm-3b", "llama3-8b",
                                  "granite-3-8b"])
def test_dense_arch_streams_match_reference(arch, engine):
    """The other dense archs of the port's registry, float32 smoke, packed
    prequant (B1; B3 on the paged engine): the jitted reference Server's
    greedy streams on the mixed-depth schedule."""
    jax = pytest.importorskip("jax")
    from repro.configs.registry import SMOKES as REF_SMOKES
    from repro.core.cim_matmul import CIMConfig as RefCIM
    from repro.models import registry as ref_registry
    from repro.runtime import server as rserver
    rcfg = REF_SMOKES[arch].replace(dtype="float32",
                                    cim=RefCIM(enabled=True))
    tcfg = SMOKES[arch].replace(dtype="float32", cim=CIMConfig(enabled=True))
    params = ref_registry.init_params(jax.random.PRNGKey(0), rcfg)
    kw = dict(n_slots=2, max_len=MAX_LEN, prequant=True)
    if engine == "paged":
        kw.update(paged=True, block_size=8, prefill_chunk=4, attn="kernel")
    srvs = ((rserver.Server(params, rcfg, rserver.ServingConfig(
                telemetry=False, **kw)), rserver.Request),
            (tserver.Server(registry.params_from_numpy(
                to_numpy_tree(params), tcfg, device="cpu"), tcfg,
                tserver.ServingConfig(**kw), device="cpu"),
             tserver.Request))
    outs = []
    for srv, Req in srvs:
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


# ---------------------------------------------------------------------------
# contracts that need no reference
# ---------------------------------------------------------------------------
def test_port_imports_no_jax_and_no_reference():
    """Every module of the port, chip_smoke, a serve on each engine (the
    paged one with the model drafter), a paged prequant serve of the MoE
    family, a --cim bp slot serve of deepseek-v3, prequant slot serves
    of rwkv6-7b, zamba2-2.7b and internvl2-26b, whisper-large-v3's
    prequant prefill and decode step over frames, the KWS GRU's forward
    on the macro, two --cim bp training steps through launch.train
    (microbatches, int8 gradient compression, checkpoints), the Fig. 18
    rows through figures.run and the quickstart example leave no JAX and
    no reference module (`repro`, or its figure modules under
    `benchmarks`) in sys.modules."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from repro_torch.configs.registry import SMOKES\n"
        "from repro_torch.models import registry\n"
        "from repro_torch.runtime.server import Request, Server, "
        "ServingConfig\n"
        "cfg = SMOKES['internlm2-1.8b']\n"
        "p = registry.init_params(cfg, seed=0, device='cpu')\n"
        "for sc in (ServingConfig(max_len=32),\n"
        "           ServingConfig(paged=True, max_len=32, block_size=8,\n"
        "                         drafter='model:internlm2-1.8b',\n"
        "                         spec_k=2)):\n"
        "    srv = Server(p, cfg, sc, device='cpu')\n"
        "    r = Request(prompt=[1, 2, 3], max_new_tokens=4)\n"
        "    srv.submit(r)\n"
        "    srv.run_until_drained()\n"
        "    assert len(r.output) == 4, r.output\n"
        "from repro_torch.core.cim_matmul import CIMConfig\n"
        "mcfg = SMOKES['qwen2-moe-a2.7b'].replace(cim=CIMConfig(enabled=True))\n"
        "srv = Server(registry.init_params(mcfg, seed=0, device='cpu'), mcfg,\n"
        "             ServingConfig(paged=True, max_len=32, block_size=8,\n"
        "                           prequant=True), device='cpu')\n"
        "r = Request(prompt=[1, 2, 3], max_new_tokens=4)\n"
        "srv.submit(r)\n"
        "srv.run_until_drained()\n"
        "assert len(r.output) == 4, r.output\n"
        "dcfg = SMOKES['deepseek-v3-671b'].replace(cim=CIMConfig(enabled=True))\n"
        "srv = Server(registry.init_params(dcfg, seed=0, device='cpu'), dcfg,\n"
        "             ServingConfig(max_len=32), device='cpu')\n"
        "r = Request(prompt=[1, 2, 3], max_new_tokens=4)\n"
        "srv.submit(r)\n"
        "srv.run_until_drained()\n"
        "assert len(r.output) == 4, r.output\n"
        "for arch in ('rwkv6-7b', 'zamba2-2.7b', 'internvl2-26b'):\n"
        "    acfg = SMOKES[arch].replace(cim=CIMConfig(enabled=True))\n"
        "    srv = Server(registry.init_params(acfg, seed=0, device='cpu'),\n"
        "                 acfg, ServingConfig(max_len=32, prequant=True),\n"
        "                 device='cpu')\n"
        "    r = Request(prompt=[1, 2, 3], max_new_tokens=4)\n"
        "    srv.submit(r)\n"
        "    srv.run_until_drained()\n"
        "    assert len(r.output) == 4, r.output\n"
        "import torch\n"
        "from repro_torch.models import gru, transformer\n"
        "from repro_torch.models.quantize import quantize_params\n"
        "wcfg = SMOKES['whisper-large-v3'].replace(cim=CIMConfig(enabled=True))\n"
        "wp = quantize_params(registry.init_params(wcfg, seed=0, device='cpu',\n"
        "                                          max_seq=32), wcfg)\n"
        "b = {'tokens': torch.tensor([[1, 2, 3]]),\n"
        "     'frames': torch.zeros(1, wcfg.encoder_len, wcfg.d_model)}\n"
        "lg, c = transformer.prefill(wp, b, wcfg, max_len=32)\n"
        "lg, c = transformer.decode_step(wp, lg.argmax(-1)[:, None], c, wcfg)\n"
        "assert lg.shape == (1, wcfg.vocab), lg.shape\n"
        "gcfg = gru.gru_config(cim=CIMConfig(enabled=True))\n"
        "gp = gru.init(gcfg, seed=0, device='cpu')\n"
        "assert gru.forward(gp, torch.ones(2, 3, 144), gcfg).shape == (2, 16)\n"
        "import tempfile\n"
        "from repro_torch.launch import train\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    train.main(['--arch', 'internlm2-1.8b', '--smoke', '--steps', '2',\n"
        "                '--batch', '2', '--seq', '8', '--cim', 'bp',\n"
        "                '--microbatch', '1', '--grad-compression',\n"
        "                '--device', 'cpu', '--ckpt', d])\n"
        "from repro_torch.figures import run as figures_run\n"
        "figures_run.main(['--only', 'fig18', '--device', 'cpu'])\n"
        "from repro_torch.examples import quickstart\n"
        "quickstart.main(['--device', 'cpu'])\n"
        "for m in ('repro_torch.core.adc', 'repro_torch.core.engine',\n"
        "          'repro_torch.models.moe', 'repro_torch.models.mla',\n"
        "          'repro_torch.models.rwkv6', 'repro_torch.models.mamba2',\n"
        "          'repro_torch.kernels.cim_mvm', 'repro_torch.kernels.ops',\n"
        "          'repro_torch.runtime.telemetry', 'repro_torch.runtime.obs',\n"
        "          'repro_torch.core.energy', 'repro_torch.core.sqnr',\n"
        "          'repro_torch.analysis.calibrate',\n"
        "          'repro_torch.analysis.precision_search',\n"
        "          'repro_torch.models.gru', 'repro_torch.examples.kws_gru',\n"
        "          'repro_torch.configs.whisper_large_v3',\n"
        "          'repro_torch.optim.optimizers', 'repro_torch.optim.schedule',\n"
        "          'repro_torch.data.tokens', 'repro_torch.parallel.collectives',\n"
        "          'repro_torch.checkpoint.ckpt', 'repro_torch.runtime.trainer',\n"
        "          'repro_torch.launch.train',\n"
        "          'repro_torch.examples.train_cim_qat',\n"
        "          'repro_torch.examples.quickstart',\n"
        "          'repro_torch.examples.sqnr_study',\n"
        "          'repro_torch.examples.serve_decode',\n"
        "          'repro_torch.figures.common', 'repro_torch.figures.run',\n"
        "          'repro_torch.figures.fig1b_schemes',\n"
        "          'repro_torch.figures.fig2_sqnr',\n"
        "          'repro_torch.figures.fig7_9_linearity',\n"
        "          'repro_torch.figures.fig10_adc_bits',\n"
        "          'repro_torch.figures.fig15_17_transfer',\n"
        "          'repro_torch.figures.fig16_noise',\n"
        "          'repro_torch.figures.fig18_pvt',\n"
        "          'repro_torch.figures.fig19_inference',\n"
        "          'repro_torch.figures.fig21_energy',\n"
        "          'repro_torch.figures.table1_summary'):\n"
        "    assert m in sys.modules, m\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
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
    ("act_scale", 0.1, "A7"), ("precision_manifest", "m.json", "A7")])
def test_serving_config_unported_options_raise(field, value, item):
    """The static grid and the precision manifest (ROADMAP A7) are ported:
    ServingConfig takes them, and a Server without CIM raises the
    reference's AssertionError for them."""
    sc = tserver.ServingConfig(**{field: value})
    assert getattr(sc, field) == value
    cfg, params = _smoke_params()
    with pytest.raises(AssertionError, match="cim.enabled"):
        tserver.Server(params, cfg, sc, device="cpu")


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--smoke", "--paged", "--requests", "2", "--max-new", "3",
                "--cim", "bp-prequant", "--attn", "kernel",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("req") >= 2 and "tok/s" in out
    assert "engine=paged" in out
