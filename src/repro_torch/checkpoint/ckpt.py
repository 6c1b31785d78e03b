"""Reader for the reference package's checkpoint format: a directory with
`arrays.npz` (leaves a0, a1, ...) and `index.json` (leaf key paths such as
"['layers']['attn']['wq']", their dtypes, and metadata). bf16 leaves are
stored as uint16 views and stay so here; `models.registry.params_from_numpy`
turns them into bf16 tensors. The save side is queued with training
(ROADMAP A10).
"""
from __future__ import annotations

import json
import os
import re

import numpy as np

_KEY = re.compile(r"\[(?:'([^']*)'|(\d+))\]")


def _path(keystr: str) -> list:
    parts = [m.group(1) if m.group(1) is not None else int(m.group(2))
             for m in _KEY.finditer(keystr)]
    if not parts:
        raise ValueError(f"unparseable checkpoint key {keystr!r}")
    return parts


def load_numpy_tree(path: str) -> tuple[dict, dict]:
    """Load a checkpoint directory into a nested dict of numpy arrays.
    Returns (tree, metadata)."""
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    tree: dict = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, key in enumerate(index["keys"]):
            *parents, leaf = _path(key)
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[f"a{i}"]
    return tree, index["metadata"]
