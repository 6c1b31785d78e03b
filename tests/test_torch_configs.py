"""The port's configs equal the reference's, field for field: every
ported arch's full and smoke config (internlm2-1.8b, stablelm-3b,
llama3-8b, granite-3-8b, qwen2-moe-a2.7b with its MoEConfig, deepseek-v3
with its MoEConfig and MLAConfig, internvl2-26b, rwkv6-7b and zamba2-2.7b
with their SSMConfigs, whisper-large-v3), and the KWS GRU's."""
import dataclasses
import importlib

import pytest

from _torch_helpers import normalize

pytest.importorskip("jax")

from repro.configs import internlm2_1_8b as ref_arch  # noqa: E402
from repro.configs import base as ref_base  # noqa: E402
from repro.core import macro as ref_macro  # noqa: E402
from repro.core import quant as ref_quant  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import internlm2_1_8b as t_arch  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
# the module, not the function the package re-exports under its name
t_cim = importlib.import_module("repro_torch.core.cim_matmul")
from repro_torch.core import macro as t_macro  # noqa: E402
from repro_torch.core import quant as t_quant  # noqa: E402

# repro.core re-exports a function named cim_matmul over the submodule
ref_cim = importlib.import_module("repro.core.cim_matmul")

ARCH_MODULES = ("stablelm_3b", "llama3_8b", "granite_3_8b",
                "qwen2_moe_a2_7b", "deepseek_v3_671b", "internvl2_26b",
                "rwkv6_7b", "zamba2_2_7b", "whisper_large_v3")

PAIRS = {
    "CONFIG": (ref_arch.CONFIG, t_arch.CONFIG),
    "SMOKE": (ref_arch.SMOKE, t_arch.SMOKE),
    "MacroConfig": (ref_macro.MacroConfig(), t_macro.MacroConfig()),
    "CIMConfig": (ref_cim.CIMConfig(), t_cim.CIMConfig()),
    "CIMConfig_enabled": (ref_cim.CIMConfig(enabled=True),
                          t_cim.CIMConfig(enabled=True)),
    "ActQuantConfig": (ref_quant.ActQuantConfig(), t_quant.ActQuantConfig()),
    "WeightQuantConfig": (ref_quant.WeightQuantConfig(),
                          t_quant.WeightQuantConfig()),
    "TRAIN_4K": (ref_base.TRAIN_4K, t_base.TRAIN_4K),
    "DECODE_32K": (ref_base.DECODE_32K, t_base.DECODE_32K),
    "TrainConfig": (ref_base.TrainConfig(), t_base.TrainConfig()),
    "gru_config": (importlib.import_module("repro.models.gru").gru_config(),
                   importlib.import_module(
                       "repro_torch.models.gru").gru_config()),
}
for _mod in ARCH_MODULES:
    _ref = importlib.import_module(f"repro.configs.{_mod}")
    _port = importlib.import_module(f"repro_torch.configs.{_mod}")
    PAIRS[f"{_mod}.CONFIG"] = (_ref.CONFIG, _port.CONFIG)
    PAIRS[f"{_mod}.SMOKE"] = (_ref.SMOKE, _port.SMOKE)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_fields_equal(name):
    ref, port = PAIRS[name]
    assert [f.name for f in dataclasses.fields(ref)] \
        == [f.name for f in dataclasses.fields(port)]
    assert normalize(ref) == normalize(port)


@pytest.mark.parametrize("vdd", [0.65, 0.7, 0.75, 0.9, 1.2])
@pytest.mark.parametrize("gain", [1.0, 2.5])
def test_macro_derived_quantities(vdd, gain):
    r = ref_macro.MacroConfig(gain=gain, op=ref_macro.OperatingPoint(vdd=vdd))
    t = t_macro.MacroConfig(gain=gain, op=t_macro.OperatingPoint(vdd=vdd))
    assert t.effective_adc_levels() == r.effective_adc_levels()
    assert t.full_scale() == r.full_scale()
    assert t.adc_lsb() == r.adc_lsb()
    assert t.full_scale(1, 1) == r.full_scale(1, 1)


def test_macro_defaults():
    m = t_macro.MacroConfig()
    assert (m.n_rows, m.adc_levels, m.effective_adc_levels()) == (144, 362,
                                                                   362)


def test_model_config_widths():
    c = t_registry.get("internlm2-1.8b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
            c.d_ff, c.vocab) == (24, 2048, 16, 8, 128, 8192, 92544)
    assert t_registry.get("internlm2-1.8b", smoke=True) == t_arch.SMOKE
    q = t_registry.get("qwen2-moe-a2.7b")
    assert (q.n_layers, q.d_model, q.n_heads, q.n_kv_heads, q.head_dim,
            q.vocab, q.moe.n_experts, q.moe.top_k, q.moe.d_ff_expert,
            q.moe.n_shared, q.moe.d_ff_shared) == (24, 2048, 16, 16, 128,
                                                   151936, 60, 4, 1408, 4,
                                                   5632)
    assert t_registry.get("stablelm-3b").head_dim == 80
    d = t_registry.get("deepseek-v3-671b")
    assert (d.n_layers, d.d_model, d.n_heads, d.head_dim, d.vocab,
            d.moe.n_experts, d.moe.top_k, d.moe.first_dense,
            d.moe.d_ff_dense, d.mla.q_lora_rank, d.mla.kv_lora_rank,
            d.mtp) == (61, 7168, 128, 56, 129280, 256, 8, 3, 18432, 1536,
                       512, True)


def test_registry_unported_arch_raises():
    """Every arch of the reference is ported (whisper-large-v3 last, ROADMAP
    A9b); an unknown arch raises KeyError, as the reference's does."""
    from repro.configs import registry as ref_registry
    with pytest.raises(KeyError, match="unknown arch"):
        t_registry.get("whisper-large-v4")
    assert sorted(t_registry.ARCHS) == sorted(t_registry.SMOKES) \
        == sorted(ref_registry.ARCHS) == [
        "deepseek-v3-671b", "granite-3-8b", "internlm2-1.8b",
        "internvl2-26b", "llama3-8b", "qwen2-moe-a2.7b", "rwkv6-7b",
        "stablelm-3b", "whisper-large-v3", "zamba2-2.7b"]


def test_cim_config_site_overrides_raise():
    """Per-site overrides (ROADMAP A7) are accepted; a bad one raises where
    the site resolves, as the reference's does."""
    ok = t_cim.CIMConfig(site_overrides=(
        ("wq", t_cim.SitePrecision(adc_levels=128)),))
    assert ok.for_site("wq").macro.adc_levels == 128
    assert ok.for_site("wk").macro.adc_levels == 362
    bad = t_cim.CIMConfig(site_overrides=(
        ("wq", t_cim.SitePrecision(adc_levels=1)),))
    with pytest.raises(ValueError, match="adc_levels"):
        bad.for_site("wq")
    with pytest.raises(ValueError):
        t_cim.CIMConfig(site_overrides=(
            ("wq", t_cim.SitePrecision(scheme="xyz")),)).for_site("wq")
