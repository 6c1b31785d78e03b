"""Training of the transformers with a prefix in the port (ROADMAP A10b)
against the reference package: whisper-large-v3 (the encoder under grad
over stub frames, the decoder's cross-attention, learned encoder and
decoder positions) and internvl2-26b (the loss on the text positions
behind the stub image prefix): `train_loss` and every gradient at --cim
off and bp. (rwkv6's and zamba2's legs, and the reference checkpoints of
all four archs, are test_torch_train_recurrent.py.)

Weights come from a reference init carried across by `params_from_numpy`,
inputs from numpy seeds (the stub frames and image embeddings N(0, 0.02²)
as `data.tokens.synthetic_batch` makes them, in f32 for the float32 smoke
models); the reference runs op by op (layers unrolled, no remat, no jit)
and is differentiated with jax.value_and_grad.

Tolerances (measured):
  * train_loss: LOSS_TOL 1e-6 relative (measured ≤ 1.4e-7; under CIM no
    DAC code moved at these inputs); per-layer remat on vs off bit for
    bit;
  * every gradient TRAIN_GRAD_TOL 1e-5 relative to its reference's largest
    |value| (measured ≤ 3.5e-6), except whisper's key-bias gradients: zero
    in exact arithmetic (softmax cancels a per-query constant), they come
    out as rounding noise on both sides, ≤ 5.0e-9 of the tree's largest
    gradient, and are held below 1e-7 of it
    (`_torch_helpers.ZERO_GRAD_BOUND`), not against each other.
"""
import numpy as np
import pytest
import torch

from _torch_helpers import check_train_loss, to_numpy_tree
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)

jax = pytest.importorskip("jax")

from repro.configs.registry import SMOKES as REF_SMOKES  # noqa: E402
from repro.data.tokens import SyntheticLMDataset  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.models import registry  # noqa: E402

LOSS_TOL = 1e-6
TRAIN_GRAD_TOL = 1e-5
SEQ, BATCH = 16, 2
ARCHS = ("whisper-large-v3", "internvl2-26b")


@pytest.fixture(scope="module")
def ref_weights():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = REF_SMOKES[arch].replace(dtype="float32")
            cache[arch] = ref_registry.init_params(jax.random.PRNGKey(0), cfg,
                                                   max_seq=SEQ + 8)
        return cache[arch]
    return get


def _batch(arch: str) -> dict:
    """tokens / labels (SEQ of them; internvl2's text shortened behind its
    image prefix, as synthetic_batch shortens it) and the stub inputs."""
    cfg = SMOKES[arch]
    b = SyntheticLMDataset(cfg.vocab, SEQ + cfg.n_image_tokens, BATCH,
                           seed=0).batch(0)
    rng = np.random.RandomState(17)
    if cfg.n_image_tokens:
        b = {k: v[:, :SEQ] for k, v in b.items()}
        b["image_embeds"] = (rng.randn(BATCH, cfg.n_image_tokens, cfg.d_model)
                             * 0.02).astype(np.float32)
    if cfg.encoder_layers:
        b["frames"] = (rng.randn(BATCH, cfg.encoder_len, cfg.d_model)
                       * 0.02).astype(np.float32)
    return b


@pytest.mark.parametrize("leg", ["off", "bp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_reference(ref_weights, arch, leg):
    """The float32 smoke model's loss and every gradient (whisper's encoder
    stack, enc_norm, enc_pos and dec_pos; internvl2's text-only loss)
    against jax.value_and_grad of the reference's train_loss; per-layer
    remat on vs off bit for bit."""
    _, grads, _ = check_train_loss(ref_weights(arch), arch, leg,
                                   _batch(arch), loss_tol=LOSS_TOL,
                                   grad_tol=TRAIN_GRAD_TOL)
    if SMOKES[arch].encoder_layers:
        assert float(grads["enc_pos"]["pos_embed"].abs().max()) > 0
        assert float(grads["enc_layers"][0]["attn"]["wk"].abs().max()) > 0
        assert float(grads["layers"][0]["xattn"]["wv"].abs().max()) > 0
        # learned decoder positions past the sequence get no gradient
        assert not grads["dec_pos"]["pos_embed"][SEQ:].any()


def test_loss_reads_the_text_positions_only(ref_weights):
    """internvl2's image embeddings are an input: the loss reaches them
    through attention (a tensor that asks for a gradient gets one), the
    labels cover the text only, and the prefix positions' logits are
    never taken: the loss equals the CE of the text positions' logits."""
    from repro_torch.models import common, transformer
    arch = "internvl2-26b"
    cfg = SMOKES[arch].replace(dtype="float32")
    p = registry.params_from_numpy(to_numpy_tree(ref_weights(arch)), cfg,
                                   device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    img = b["image_embeds"].clone().requires_grad_()
    loss = registry.train_loss(p, {**b, "image_embeds": img}, cfg)
    (g,) = torch.autograd.grad(loss, img)
    assert g.shape == img.shape and float(g.abs().max()) > 0
    assert b["labels"].shape[1] == SEQ
    with torch.no_grad():
        h, _, _ = transformer.forward(p, b, cfg, train=False)
        want = common.cross_entropy(
            common.unembed(p["tok"], h[:, cfg.n_image_tokens:], cfg),
            b["labels"].long())
    assert torch.equal(loss.detach(), want)
