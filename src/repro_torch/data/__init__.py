"""Deterministic synthetic data (the reference's `data` package)."""
from .tokens import SyntheticLMDataset, synthetic_batch

__all__ = ["SyntheticLMDataset", "synthetic_batch"]
