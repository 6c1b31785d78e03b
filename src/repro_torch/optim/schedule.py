"""Learning-rate schedules (the reference's `optim/schedule.py`)."""
from __future__ import annotations

import math

import torch


def cosine_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """Linear warmup → cosine decay to floor·peak: lr(step) for an integer
    step tensor → an f32 tensor on its device, in the reference's f32 op
    order (divisors as tensors: true divisions)."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()

        def f32(v):
            return torch.full((), float(v), dtype=torch.float32,
                              device=s.device)

        warm = peak_lr * s / f32(max(warmup_steps, 1))
        prog = torch.clamp((s - warmup_steps)
                           / f32(max(total_steps - warmup_steps, 1)),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)
    return lr
