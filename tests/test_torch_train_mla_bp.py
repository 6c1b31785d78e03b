"""Training of deepseek-v3-671b in the port (ROADMAP A10b) against the
reference package at --cim bp: `train_loss` with every gradient and MLA
under `train`, every float weight's forward on the macro through
`cim_matmul_ste` (the routed experts' in one expert-batched call). The
--cim off leg and the tolerances are in test_torch_train_mla.py; this leg
has a file of its own because the reference's first op-by-op gradient
pass at --cim bp compiles each op of its interpreted Pallas kernels, about
a minute for this model.

Under CIM no DAC code and no top-k choice moved at these inputs, so the
tolerances of the --cim off leg hold.
"""
import pytest
import torch

from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")

from test_torch_train_mla import (check_deepseek_train_loss,  # noqa: E402
                                  check_mla_apply, reference_params)


@pytest.fixture(scope="module")
def ref_params():
    return reference_params()


def test_train_loss_and_gradients_match_reference(ref_params):
    check_deepseek_train_loss(ref_params, "bp")


def test_mla_apply_train_gradients_match_reference(ref_params):
    check_mla_apply(ref_params, "bp")
