"""Shared helpers of the tests that hold the PyTorch port against the JAX
reference package: dataclass normalization, weight transfer, the float32
smoke configs of a CIM leg and the slot Server's mixed-length schedule."""
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


def rel_err(a, b) -> float:
    """max |a − b| relative to the largest |b| (at least 1e-6)."""
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def leg_cfgs(arch: str, leg: str):
    """(reference cfg, port cfg) of the float32 smoke `arch` for a leg:
    "off", "bp" (IDEAL) or "bp-noisy" (NOISY, noise_seed 0, as serve.py
    builds it); the reference's layers unrolled (op by op when not
    jitted)."""
    from repro.configs.registry import SMOKES as REF_SMOKES
    from repro.core.cim_matmul import CIMConfig as RefCIM
    from repro.core.macro import SimLevel as RefLevel
    from repro_torch.configs.registry import SMOKES
    from repro_torch.core.cim_matmul import CIMConfig
    from repro_torch.core.macro import SimLevel
    ref = REF_SMOKES[arch].replace(dtype="float32", scan_layers=False)
    port = SMOKES[arch].replace(dtype="float32")
    if leg == "off":
        return ref, port
    out = []
    for cfg, cim_cls, level in ((ref, RefCIM, RefLevel),
                                (port, CIMConfig, SimLevel)):
        cim = cim_cls(enabled=True)
        if leg == "bp-noisy":
            cim = dataclasses.replace(
                cim_cls(enabled=True, noise_seed=0),
                macro=dataclasses.replace(cim.macro,
                                          sim_level=level.NOISY))
        out.append(cfg.replace(cim=cim))
    return tuple(out)


def mixed_depth(srv, req_cls):
    """The slot tests' randomized admission on a Server (either package):
    5 requests of 3–8 prompt tokens and 2–5 new tokens, submitted at steps
    0, 0, 2, 3 and 7. Returns the streams."""
    rng = np.random.RandomState(42)
    schedule = {0: 2, 2: 1, 3: 1, 7: 1}
    reqs, step = [], 0
    while reqs == [] or any(not r.done for r in reqs) or srv.queue:
        for _ in range(schedule.get(step, 0)):
            n = int(rng.randint(3, 9))
            r = req_cls(prompt=rng.randint(0, 512, size=n).tolist(),
                        max_new_tokens=int(rng.randint(2, 6)))
            srv.submit(r)
            reqs.append(r)
        srv.step()
        step += 1
        assert step < 200
    return [r.output for r in reqs]
