"""Mesh construction on torch.distributed.

Functions, not module-level constants: importing this module starts no
process group. A mesh function initialises the default process group
when none is: nccl on the card, gloo on the CPU; from torchrun's
environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK) when
it is set, else as one rank over an in-process HashStore. A mesh whose
shape does not match the world size raises.

  # four CPU processes on a 2 x 2 (data, model) mesh
  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --smoke \\
      --paged --cim bp-prequant --mesh host --device cpu
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def world_size() -> int:
    """The process group's size, or torchrun's WORLD_SIZE before one is
    initialised (1 without either)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_process_group(device=None) -> torch.device:
    """Initialise the default process group unless one is (nccl for the
    card, gloo for the CPU); returns the resolved device, on the card this
    rank's (LOCAL_RANK)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    return dev


def make_mesh(shape, axes, *, device=None):
    """A DeviceMesh of `shape` with axis names `axes` over the world."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = world_size()
    if math.prod(shape) != n:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} ranks, the world has {n}")
    dev = init_process_group(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None):
    """A (data, model) mesh over the world's ranks."""
    return make_mesh((data, model), ("data", "model"), device=device)


def make_host_smoke_mesh(*, device=None):
    """(mesh, data, model) over every rank: model is the largest of 4 / 2
    / 1 that divides the world size, data the rest (`serve.py --mesh
    host`)."""
    n = world_size()
    model = next(m for m in (4, 2, 1) if n % m == 0)
    return make_host_mesh(n // model, model, device=device), n // model, model
