"""Atomic, keep-N checkpointing in the reference package's format: a
directory holding `arrays.npz` (leaves a0, a1, ... in sorted key order) and
`index.json` (the leaf key paths, such as "['params']['layers'][0]['attn']
['wq']" — a dict key as ['name'], a list index as [i], the reference's
keystr — their dtypes and metadata). bf16 leaves are stored as uint16
views (npz has no bf16).

  * Leaves are written whole, from the host, so a run can resume on
    another device.
  * Writes are atomic: a temporary directory, then a rename, so a
    preemption mid-write never leaves a torn latest checkpoint.
  * `CheckpointManager` keeps the newest N step directories and restores
    the newest.

`load_numpy_tree` reads any such directory (the reference's or the
port's) into nested dicts of numpy arrays; `models.registry.
params_from_numpy` / `state_from_numpy` turn them into the port's tensors.
`load_pytree` reads into the structure of a like-tree of tensors.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time

import numpy as np
import torch

_KEY = re.compile(r"\[(?:'([^']*)'|(\d+))\]")


def _path(keystr: str) -> list:
    parts = [m.group(1) if m.group(1) is not None else int(m.group(2))
             for m in _KEY.finditer(keystr)]
    if not parts:
        raise ValueError(f"unparseable checkpoint key {keystr!r}")
    return parts


def _keystr(path) -> str:
    return "".join(f"[{k}]" if isinstance(k, int) else f"['{k}']"
                   for k in path)


def _flatten(tree, prefix=()) -> dict:
    """{keystr: leaf} over dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flatten(sub, prefix + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flatten(sub, prefix + (i,)).items()}
    return {_keystr(prefix): tree}


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array as stored, dtype name as index.json records it)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_pytree(path: str, tree, *, metadata: dict | None = None) -> None:
    """Atomically write `tree` (dicts, lists and tensors) to the directory
    `path`, replacing what was there."""
    tmp = path + f".tmp.{os.getpid()}.{int(time.time() * 1e6)}"
    os.makedirs(tmp, exist_ok=True)
    flat = sorted(_flatten(tree).items())
    arrays, dtypes = {}, {}
    for i, (k, v) in enumerate(flat):
        arrays[f"a{i}"], dtypes[k] = _to_numpy(v)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump({"keys": [k for k, _ in flat], "dtypes": dtypes,
                   "metadata": metadata or {}}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def _index(path: str) -> dict:
    with open(os.path.join(path, "index.json")) as f:
        return json.load(f)


def load_numpy_tree(path: str) -> tuple[dict, dict]:
    """Load a checkpoint directory into a nested dict of numpy arrays (a
    list index becomes an int key; bf16 leaves stay uint16 views).
    Returns (tree, metadata)."""
    index = _index(path)
    tree: dict = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, key in enumerate(index["keys"]):
            *parents, leaf = _path(key)
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[f"a{i}"]
    return tree, index["metadata"]


def load_pytree(path: str, like, *, device=None):
    """Load into the structure of `like` (a tree of tensors): each leaf
    takes its like-leaf's dtype and lands on `device` (default: the
    like-leaf's). Raises KeyError for a leaf the checkpoint lacks and
    ValueError for a shape mismatch. Returns (tree, metadata)."""
    index = _index(path)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[f"a{i}"] for i, k in enumerate(index["keys"])}

    def load(leaf, prefix):
        if isinstance(leaf, dict):
            return {k: load(v, prefix + (k,)) for k, v in leaf.items()}
        if isinstance(leaf, list):
            return [load(v, prefix + (i,)) for i, v in enumerate(leaf)]
        k = _keystr(prefix)
        if k not in arrays:
            raise KeyError(f"checkpoint missing leaf {k}")
        a = arrays[k]
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {k}: ckpt {a.shape} vs "
                             f"model {tuple(leaf.shape)}")
        if index["dtypes"][k] == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        return t.to(device if device is not None else leaf.device,
                    leaf.dtype)

    return load(like, ()), index["metadata"]


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.count(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree, *, metadata: dict | None = None) -> None:
        md = dict(metadata or {})
        md["step"] = step
        save_pytree(self.step_dir(step), tree, metadata=md)
        for old in self.steps()[:-self.keep]:
            shutil.rmtree(self.step_dir(old), ignore_errors=True)

    def restore(self, like, *, step: int | None = None, device=None):
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return load_pytree(self.step_dir(step), like, device=device)
