"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A call
that does not ask for the CPU on a machine without a GPU raises: nothing
carries on quietly on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` or "cuda" → the current CUDA device (raises without one);
    "cpu" (or a CPU torch.device) → the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
