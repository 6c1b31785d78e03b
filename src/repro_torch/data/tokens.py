"""Deterministic synthetic data pipelines: the port's copy of the
reference's `data/tokens.py` (numpy only, so the batches are the
reference's bit for bit).

No corpus is read. The LM stream is a learnable synthetic language (motif
sequences) so the training loss falls; batches are a pure function of
(seed, step, host_id), so any host count and any restart step reproduce
the same global batch — the property the checkpoint-restart tests rely on
(no data-loader state to snapshot).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    motif_len: int = 8
    n_motifs: int = 64

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        v = max(4, self.vocab - 1)
        self.motifs = rng.randint(1, v, size=(self.n_motifs, self.motif_len))

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        return self.global_batch // self.n_hosts

    def batch(self, step: int) -> dict:
        """→ {"tokens": [B_host, S], "labels": [B_host, S]} int32 numpy."""
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step) * 977 + self.host_id)
        b, s = self.host_batch, self.seq_len
        seq = np.zeros((b, s + 1), np.int64)
        pos = np.zeros(b, np.int64)
        while pos.min() < s + 1:
            ids = rng.randint(0, self.n_motifs, size=b)
            for i in range(b):
                if pos[i] >= s + 1:
                    continue
                m = self.motifs[ids[i]]
                take = min(self.motif_len, s + 1 - pos[i])
                seq[i, pos[i]:pos[i] + take] = m[:take]
                pos[i] += take
        seq = seq % self.vocab
        return {"tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, step: int = 0,
                    seed: int = 0, device=None) -> dict:
    """One batch of torch tensors on `device` (default: the card) as the
    reference's `synthetic_batch` makes it: tokens and labels int32; for a
    VLM the text shortened by n_image_tokens and "image_embeds" [B,
    n_image_tokens, D]; for an encoder-decoder "frames" [B, encoder_len,
    D]; both stubs N(0, 0.02²) from RandomState(seed + 17), in bf16."""
    dev = resolve_device(device)
    ds = SyntheticLMDataset(cfg.vocab, shape.seq_len, shape.global_batch,
                            seed=seed)
    base = ds.batch(step)
    out = {k: torch.from_numpy(v).to(dev) for k, v in base.items()}
    rng = np.random.RandomState(seed + 17)
    if cfg.n_image_tokens:
        t = shape.seq_len - cfg.n_image_tokens
        out = {"tokens": out["tokens"][:, :t], "labels": out["labels"][:, :t]}
        out["image_embeds"] = torch.from_numpy(
            rng.randn(shape.global_batch, cfg.n_image_tokens,
                      cfg.d_model).astype(np.float32) * 0.02).to(
            dev, torch.bfloat16)
    if cfg.encoder_layers:
        out["frames"] = torch.from_numpy(
            rng.randn(shape.global_batch, cfg.encoder_len,
                      cfg.d_model).astype(np.float32) * 0.02).to(
            dev, torch.bfloat16)
    return out
