"""GPipe-style pipeline parallelism over a mesh "stage" axis.

The reference's building block for depth-dominated configs (its
production meshes use DP x TP x EP only, so no launcher runs it; the
tests do). Schedule: the classic fill-drain loop. At tick t, stage s
processes microbatch t - s; activations hop stage -> stage + 1 by
point-to-point sends (`sharding.send_recv`). Every rank runs the same
function, applying its own slice of the stacked stage parameters; at the
end the last stage's outputs are broadcast to every rank of the stage
group.
"""
from __future__ import annotations

import torch

from repro_torch.parallel import sharding


def pipeline_apply(stage_fn, stage_params, x_micro: torch.Tensor, *, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Run `n_micro` microbatches through `n_stages` pipeline stages.

    stage_fn(params_slice, h) -> h           (one stage's computation)
    stage_params: a tensor (or a dict / list tree of tensors) with a
      leading [n_stages] dim, whole on every rank; this rank uses slice
      [its stage]
    x_micro: [n_micro, mb, ...] microbatched inputs, whole on every rank
    mesh: a DeviceMesh with an `axis` dimension.
    Returns [n_micro, mb, ...]: the last stage's outputs, on every rank.
    """
    group = mesh.get_group(axis)
    n_stages = sharding.group_size(group)
    n_micro = x_micro.shape[0]
    assert n_micro >= n_stages, "need >= n_stages microbatches to fill"
    sid = mesh.get_local_rank(axis)

    def local(tree):
        if isinstance(tree, dict):
            return {k: local(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(local(v) for v in tree)
        return tree[sid]

    params = local(stage_params)
    outs = torch.zeros_like(x_micro)
    h_in = torch.zeros_like(x_micro[0])
    for t in range(n_micro + n_stages - 1):
        h = x_micro[min(t, n_micro - 1)] if sid == 0 else h_in
        mb = t - sid
        if 0 <= mb < n_micro:
            h = stage_fn(params, h)
            if sid == n_stages - 1:
                outs[mb] = h
        # hop to the next stage: s sends to s + 1, s + 1 receives from s
        if n_stages > 1:
            if sid > 0:
                h_in = torch.empty_like(h_in)
            sharding.send_recv(h if sid + 1 < n_stages else None, sid + 1,
                               h_in if sid > 0 else None, sid - 1, group)
    sharding.broadcast(outs, n_stages - 1, group)
    return outs
