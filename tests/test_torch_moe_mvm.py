"""The plain versions of the expert-batched MVMs (B1e, B6e over packed
codes; B2e, B5e over dense f32 codes) against the reference.

The reference runs the MoE routed experts as `jax.vmap` of its Pallas
kernels over the expert axis (`src/repro/models/moe.py`); here the same
vmap runs in interpret mode on numpy-seeded codes at small ragged shapes,
and `cim_mvm_grouped_packed_experts_plain` /
`cim_mvm_grouped_noisy_packed_experts_plain` /
`cim_mvm_grouped_experts_plain` / `cim_mvm_grouped_noisy_experts_plain`
must equal it bit for bit (every expert draws the noise of a 2-D call on
its own operands: the hash takes no expert index). The dense cases take
rows above one 8-row tile and 8-bit codes (act_bits = weight_bits = 8 on
both packages' MacroConfig: codes up to 255, the widest the card's
tensor-core body of B2e / B5e takes). At FULL the INL curve's sin differs
from XLA's in the last bit for some arguments, so FULL is held within
test_torch_noisy.py's FULL_TOL (one output per MVM, one ADC step). The card
holds the CUDA kernels against exactly these plain versions
(test_torch_gpu.py, `chip_smoke.py` phases 3m, 3d, 3y and "ep").
"""
import numpy as np
import pytest
import torch

from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.macro import MacroConfig as RefMacro  # noqa: E402
from repro.core.macro import SimLevel as RefLevel  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core.macro import MacroConfig, SimLevel  # noqa: E402
from repro_torch.kernels import cim_mvm, ops  # noqa: E402

# (E, M, K, N): odd K, K not a multiple of 144, M above one 8-row tile, N
# no multiple of 8; one expert of one row
SHAPES = [(3, 9, 301, 40), (1, 1, 301, 40)]
LSB = np.float32(32400.0 / 361)       # default macro: full scale / (L - 1)
FULL_TOL = (1, 1)                     # outputs that may differ, ADC steps


def _operands(e, m, k, n):
    rng = np.random.RandomState(e * 1000 + m * 100 + k + n)
    x = rng.randint(0, 16, (e, m, k)).astype(np.float32)
    w = rng.randint(0, 16, (e, k, n)).astype(np.float32)
    return x, np.array(ref_ops.pack_codes(jnp.asarray(w)))


def _ref_vmap(fn, x, wp):
    return np.asarray(jax.vmap(fn)(jnp.asarray(x), jnp.asarray(wp)))


@pytest.mark.parametrize("e,m,k,n", SHAPES)
def test_b1e_plain_bit_exact_vs_reference_vmap(e, m, k, n):
    x, wp = _operands(e, m, k, n)
    yr = _ref_vmap(lambda xe, we: ref_ops.cim_mvm_pallas_packed(
        xe, we, RefMacro(), interpret=True), x, wp)
    yt = cim_mvm.cim_mvm_grouped_packed_experts_plain(
        torch.from_numpy(x), torch.from_numpy(wp),
        **ops._kernel_kw(MacroConfig()))
    assert yt.shape == (e, m, n)
    assert np.array_equal(yr, yt.numpy())


@pytest.mark.parametrize("level", ["noisy", "full"])
@pytest.mark.parametrize("e,m,k,n", SHAPES)
def test_b6e_plain_vs_reference_vmap(e, m, k, n, level):
    x, wp = _operands(e, m, k, n)
    rmac = RefMacro(sim_level=RefLevel(level))
    kw = ops._check_stochastic(MacroConfig(sim_level=SimLevel(level)))
    for seed, inl_seed in ((0, 0), (7, 3)):
        yr = _ref_vmap(lambda xe, we: ref_ops.cim_mvm_pallas_noisy_packed(
            xe, we, rmac, noise_seed=seed, inl_seed=inl_seed,
            interpret=True), x, wp)
        yt = cim_mvm.cim_mvm_grouped_noisy_packed_experts_plain(
            torch.from_numpy(x), torch.from_numpy(wp),
            torch.tensor([seed], dtype=torch.int32), inl_seed=inl_seed,
            **kw).numpy()
        if level == "noisy":
            assert np.array_equal(yr, yt), (seed, inl_seed)
            continue
        for i in range(e):
            diff = yt[i] != yr[i]
            assert int(diff.sum()) <= FULL_TOL[0], (seed, inl_seed, i)
            steps = np.abs(yt[i][diff] - yr[i][diff]) / LSB
            assert np.all(np.abs(steps - np.round(steps)) < 1e-3)
            assert np.all(steps <= FULL_TOL[1] + 1e-3)


# (E, M, K, N, code bits) of the dense experts: odd K, rows above one 8-row
# tile (and above 40, the card's tall tile), N no multiple of 4, 8-bit codes
DENSE_SHAPES = [(3, 9, 301, 40, 4), (2, 41, 160, 14, 4), (2, 10, 301, 24, 8)]


def _dense_operands(e, m, k, n, bits):
    rng = np.random.RandomState(e * 1000 + m * 100 + k + n + bits)
    q = 1 << bits
    return (rng.randint(0, q, (e, m, k)).astype(np.float32),
            rng.randint(0, q, (e, k, n)).astype(np.float32))


def _assert_full(yr, yt, bits, tag):
    """FULL_TOL: at most one output per expert off, by whole ADC steps."""
    lsb = np.float32(144 * ((1 << bits) - 1) ** 2 / 361)
    for i in range(yr.shape[0]):
        diff = yt[i] != yr[i]
        assert int(diff.sum()) <= FULL_TOL[0], (tag, i)
        steps = np.abs(yt[i][diff] - yr[i][diff]) / lsb
        assert np.all(np.abs(steps - np.round(steps)) < 1e-3), (tag, i)
        assert np.all(steps <= FULL_TOL[1] + 1e-3), (tag, i)


@pytest.mark.parametrize("e,m,k,n,bits", DENSE_SHAPES)
def test_b2e_plain_bit_exact_vs_reference_vmap(e, m, k, n, bits):
    x, w = _dense_operands(e, m, k, n, bits)
    rmac = RefMacro(act_bits=bits, weight_bits=bits)
    yr = _ref_vmap(lambda xe, we: ref_ops.cim_mvm_pallas(
        xe, we, rmac, interpret=True), x, w)
    yt = cim_mvm.cim_mvm_grouped_experts_plain(
        torch.from_numpy(x), torch.from_numpy(w),
        **ops._kernel_kw(MacroConfig(act_bits=bits, weight_bits=bits)))
    assert yt.shape == (e, m, n)
    assert np.array_equal(yr, yt.numpy())


@pytest.mark.parametrize("level", ["noisy", "full"])
@pytest.mark.parametrize("e,m,k,n,bits", DENSE_SHAPES)
def test_b5e_plain_vs_reference_vmap(e, m, k, n, bits, level):
    x, w = _dense_operands(e, m, k, n, bits)
    rmac = RefMacro(act_bits=bits, weight_bits=bits,
                    sim_level=RefLevel(level))
    kw = ops._check_stochastic(MacroConfig(act_bits=bits, weight_bits=bits,
                                           sim_level=SimLevel(level)))
    for seed, inl_seed in ((0, 0), (7, 3)):
        yr = _ref_vmap(lambda xe, we: ref_ops.cim_mvm_pallas_noisy(
            xe, we, rmac, noise_seed=seed, inl_seed=inl_seed,
            interpret=True), x, w)
        yt = cim_mvm.cim_mvm_grouped_noisy_experts_plain(
            torch.from_numpy(x), torch.from_numpy(w),
            torch.tensor([seed], dtype=torch.int32), inl_seed=inl_seed,
            **kw).numpy()
        assert yt.shape == (e, m, n)
        if level == "noisy":
            assert np.array_equal(yr, yt), (seed, inl_seed)
        else:
            _assert_full(yr, yt, bits, (seed, inl_seed))
