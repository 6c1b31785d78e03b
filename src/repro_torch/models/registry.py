"""Model registry: ModelConfig.family → implementation module, the training
loss dispatch, plus the bridge that carries the reference package's
weights and training state across.

Every family is ported: the dense, MoE, VLM and audio (whisper's
encoder-decoder) transformers, RWKV6 ("ssm") and the Mamba2 / Zamba2
hybrid ("hybrid"). The paper's KWS GRU (`models.gru`, family "audio"
too) is built by its own module, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from . import mamba2, rwkv6, transformer

_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "audio": transformer, "ssm": rwkv6, "hybrid": mamba2}


def get_module(cfg: ModelConfig):
    return _FAMILY[cfg.family]


def train_loss(params: dict, batch: dict, cfg: ModelConfig, rng=None):
    """The family module's training loss: a scalar f32 tensor to
    differentiate (the reference's `train_loss(params, batch, cfg, rng)`)."""
    return get_module(cfg).train_loss(params, batch, cfg, rng)


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None, **kw):
    """`max_seq` (in kw) sizes the transformer's learned positions; the
    other modules take it and ignore it, as in the reference."""
    return get_module(cfg).init(cfg, seed=seed, device=device, **kw)


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)        # a writable copy torch may own
    if a.dtype == np.uint16:              # bf16 stored as a uint16 view
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference package's parameter tree, as numpy arrays, → the
    port's params on `device`.

    Stacked [L, ...] leaves under "dense_layers" (MoEConfig.first_dense
    layers), "layers" (the other n_layers − first_dense) and "enc_layers"
    (whisper's encoder_layers) become one dict per layer (the MoE FFN's
    router [L, D, E], experts [L, E, D, F] and shared gate too; whisper's
    "norm_x" / "xattn"; RWKV6's {"norm1", "tm", "norm2", "cm"}; Mamba2's
    {"norm1", "ssm"}); every other entry ("tok", "final_norm", whisper's
    "enc_norm", "enc_pos" and "dec_pos", deepseek's "mtp", zamba2's one
    weight-shared block "shared") is carried as it is; bf16 leaves arrive
    as uint16 views (the checkpoint format's encoding).

    The port's own layout is taken too: a layer stack read back from the
    port's checkpoint (`checkpoint.ckpt.load_numpy_tree`) is a dict keyed
    by layer index 0 ... L − 1, and becomes the list of those layers.
    """
    get_module(cfg)
    dev = resolve_device(device)

    def split(node, i):
        if isinstance(node, dict):
            return {k: split(v, i) for k, v in node.items()}
        return _to_tensor(node[i], dev)

    n_dense = cfg.moe.first_dense if cfg.moe is not None else 0
    depth = {"dense_layers": n_dense, "layers": cfg.n_layers - n_dense,
             "enc_layers": cfg.encoder_layers}
    out = {}
    for k, v in tree.items():
        if k in depth and _per_layer(v):
            out[k] = [_conv(v[i], dev) for i in range(len(v))]
        elif k in depth:
            out[k] = [split(v, i) for i in range(depth[k])]
        else:
            out[k] = _conv(v, dev)
    return out


def _conv(node, dev):
    if isinstance(node, dict):
        return {k: _conv(v, dev) for k, v in node.items()}
    return _to_tensor(node, dev)


def _per_layer(node) -> bool:
    """A layer stack in the port's layout: a dict keyed by layer index."""
    return isinstance(node, dict) and bool(node) \
        and all(isinstance(k, int) for k in node)


def state_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """A trainer state read back as numpy ({"params", "opt", ("err")}, from
    the reference's CheckpointManager or from the port's) → the port's
    state on `device`. params, AdamW's {"m", "v"} and the error-feedback
    buffers "err" are parameter-shaped and split per layer like the params
    (`params_from_numpy`); "step" becomes a 0-dim tensor; Adafactor's
    "stats" stay in the reference's stacked layout, which the port's
    Adafactor keeps (optim.optimizers: a stacked leaf's factored
    statistics and RMS clip span its layers)."""
    dev = resolve_device(device)
    opt = tree["opt"]
    out_opt = {"step": _to_tensor(opt["step"], dev)}
    for k in ("m", "v"):
        if k in opt:
            out_opt[k] = params_from_numpy(opt[k], cfg, dev)
    if "stats" in opt:
        out_opt["stats"] = _conv(opt["stats"], dev)
    state = {"params": params_from_numpy(tree["params"], cfg, dev),
             "opt": out_opt}
    if "err" in tree:
        state["err"] = params_from_numpy(tree["err"], cfg, dev)
    return state
