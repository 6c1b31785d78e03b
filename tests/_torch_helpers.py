"""Shared helpers of the tests that hold the PyTorch port against the JAX
reference package: dataclass normalization and weight transfer."""
from __future__ import annotations

import dataclasses
import enum

import numpy as np


def normalize(obj):
    """A dataclass tree as plain data (enums by value), so configs of the
    two packages compare field by field."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: normalize(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, tuple):
        return tuple(normalize(o) for o in obj)
    return obj


def to_numpy_tree(tree):
    """A JAX parameter tree → nested dict of numpy arrays, bf16 as uint16
    views (the checkpoint format's encoding)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    return a


def np32(t):
    """A torch tensor (any float dtype) or a JAX array → f32 numpy."""
    if hasattr(t, "detach"):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def gpu_device():
    """The CUDA device, or skip the calling test when there is none."""
    import pytest
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")
