"""The paper's custom KWS/wake-word GRU (§V-C, Fig. 20).

A 0.16M-parameter gated recurrent unit whose input and hidden dimensions
are both 144 — sized so every gate matmul is exactly one macro depth (N =
144 rows) per input half. Audio frames (stub MFCC features) stream through
the recurrence; a linear head classifies keywords.

Every gate matmul routes through `_mm`, the CIM switch of `common.dense`:
stored codes (`<name>_q`, `<name>_scale` from models.quantize) run B1, or
B6 under a noise_seed at NOISY/FULL; float weights under CIM run B2 / B5,
and under `train` the STE wrapper (`cim_matmul_ste`: the analog forward,
the float matmul's gradient); with CIM off the float matmul. The same
model trains in float or on the macro (QAT) and deploys on the macro. The
reference scans over time; `forward` here is a Python loop over T.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.core.cim_matmul import (CIMConfig, cim_matmul,
                                         cim_matmul_prequant, cim_matmul_ste)
from repro_torch.device import resolve_device
from repro_torch.parallel import sharding

from .common import _normal


def gru_config(*, cim: CIMConfig | None = None,
               n_classes: int = 16) -> ModelConfig:
    return ModelConfig(
        arch="kws-gru-144", family="audio", n_layers=1, d_model=144,
        n_heads=1, n_kv_heads=1, d_ff=144, vocab=n_classes,
        dtype="float32", cim=cim or CIMConfig())


def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random f32 weights from a torch.Generator seeded with `seed`: gates
    [2D, D] ~ N(0, 1/(2D)), zero biases, head [D, n_classes] ~ N(0, 1/D).
    The draws differ from the reference's jax.random ones;
    `registry.params_from_numpy` carries its weights across instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    s = 1.0 / math.sqrt(2 * d)
    p = {name: _normal(gen, (2 * d, d), dev) * s
         for name in ("w_z", "w_r", "w_h")}
    p.update({name: torch.zeros(d, device=dev)
              for name in ("b_z", "b_r", "b_h")})
    p["head"] = _normal(gen, (d, cfg.vocab), dev) / math.sqrt(d)
    return p


def _mm(p: dict, name: str, x: torch.Tensor, cfg: ModelConfig,
        train: bool) -> torch.Tensor:
    """Gate / head matmul: stored codes when the params hold them, else the
    float weights, on the macro when cfg.cim.enabled (through the STE
    wrapper under `train`)."""
    if cfg.cim.enabled and name + "_q" in p:
        with quant.act_site(name):
            return cim_matmul_prequant(x, p[name + "_q"], p[name + "_scale"],
                                       cfg.cim)
    if cfg.cim.enabled:
        fn = cim_matmul_ste if train else cim_matmul
        with quant.act_site(name):
            return fn(x, p[name], cfg.cim)
    return x @ p[name]


def gru_cell(p: dict, x_t: torch.Tensor, h: torch.Tensor, cfg: ModelConfig,
             *, train: bool) -> torch.Tensor:
    """One GRU step. x_t, h: [B, 144]."""
    xh = torch.cat([x_t, h], dim=-1)                # [B, 288] = 2 groups
    z = torch.sigmoid(_mm(p, "w_z", xh, cfg, train) + p["b_z"])
    r = torch.sigmoid(_mm(p, "w_r", xh, cfg, train) + p["b_r"])
    xrh = torch.cat([x_t, r * h], dim=-1)
    h_tilde = torch.tanh(_mm(p, "w_h", xrh, cfg, train) + p["b_h"])
    return (1 - z) * h + z * h_tilde


def forward(p: dict, frames: torch.Tensor, cfg: ModelConfig, *,
            train: bool = False) -> torch.Tensor:
    """frames [B, T, 144] (stub MFCC embeddings) → logits [B, n_classes]."""
    h = torch.zeros((frames.shape[0], cfg.d_model), dtype=frames.dtype,
                    device=frames.device)
    for t in range(frames.shape[1]):
        h = gru_cell(p, frames[:, t], h, cfg, train=train)
    return _mm(p, "head", h, cfg, train)


def train_loss(p: dict, batch: dict, cfg: ModelConfig,
               rng=None) -> torch.Tensor:
    """Mean cross-entropy of the keyword labels (`rng` is taken for the
    reference's signature)."""
    # a placed state is gathered once: the cell runs every frame
    logits = forward(sharding.gathered(p), batch["frames"], cfg, train=True)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, batch["labels"].long()[:, None]).mean()
