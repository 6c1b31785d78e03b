"""Optimizers and schedules as plain functions on trees of tensors (the
reference's `optim` package)."""
from .optimizers import adafactor, adamw, apply_updates, global_norm_clip
from .schedule import cosine_warmup

__all__ = ["adamw", "adafactor", "apply_updates", "global_norm_clip",
           "cosine_warmup"]
