"""Optimizers as plain functions on trees of tensors (the reference's
`optim/optimizers.py`; `torch.optim` computes other numbers).

AdamW keeps f32 m/v state; Adafactor keeps factored f32 second moments
(row and column means) for leaves of two or more dims.

API: opt = adamw(lr_fn, ...); state = opt.init(params);
     updates, state = opt.update(grads, state, params);
     params = apply_updates(params, updates).

A tree is nested dicts of tensors, where a list of same-structured dicts
is a layer stack (the port's per-layer params, where the reference keeps
one stacked [L, ...] leaf per weight name). Elementwise rules (AdamW, the
clip's scale, apply_updates) do not see the difference. Adafactor does:
the reference factors a stacked leaf [L, *S] as one tensor (a per-layer
[D] norm scale becomes a factored [L, D] matrix whose column statistic
spans the layers, and its RMS clip is taken over all L layers), so here a
layer stack's leaf path is stacked into that [L, *S] tensor for the update
and its statistics are kept in the reference's stacked layout.

Every scalar is an f32 tensor on the leaves' device, combined in the
reference's op order: m = b1·m + (1 − b1)·g, the bias corrections
1 − b1^step as f32 powers, (m/bc1) / (√(v/bc2) + eps), the casts back to
the parameter dtype in apply_updates. Divisors are tensors, so every
division is a true division on every device.

On a mesh the Trainer's state is placed (`parallel.sharding`): each rank
holds its block of every leaf, and `global_norm_clip` and `update` take
the params' spec tree (`specs`). The elementwise rules run on the blocks
as they are. A reduction over a cut dim (the clip's norm, Adafactor's row
and column statistics and its RMS clip) is the block's sum, summed over
the axes that cut those dims in ascending rank order
(`sharding.sum_over_ranks`), then divided by the whole count: the same
bits on every rank, within float reassociation of the whole tensor's
reduction (a leaf that no live axis cuts keeps the whole-tensor op).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.parallel import sharding
from repro_torch.trees import tree_leaves, tree_map  # noqa: F401 (re-export)


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
def _get(node, path):
    for k in path:
        node = node[k]
    return node


def _leaf_paths(node, prefix=()):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _leaf_paths(node[k], prefix + (k,))
    else:
        yield prefix


def stacked_groups(tree) -> list:
    """[(path, members)]: one entry per reference leaf. A plain leaf is
    (its path, None); a leaf path of a layer stack (a list of layer dicts)
    is (stack path + path in the layer, [(layer index, path in the layer)
    ...]) — the leaf the reference stacks as [L, ...]."""
    out = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (k,))
        elif isinstance(node, list):
            # an empty stack (deepseek cut to its dense layers) has no leaf
            for lp in _leaf_paths(node[0]) if node else ():
                out.append((prefix + lp,
                            [(prefix + (i,) + lp) for i in range(len(node))]))
        else:
            out.append((prefix, None))

    walk(tree, ())
    return out


def group_tensor(tree, members, path) -> torch.Tensor:
    """The reference's leaf of a group: the stacked [L, ...] tensor of a
    layer stack's leaf path, else the leaf itself."""
    if members is None:
        return _get(tree, path)
    return torch.stack([_get(tree, m) for m in members])


def set_group(tree, members, path, value: torch.Tensor) -> None:
    """Write a group's value (stacked [L, ...] for a layer stack) back
    into `tree`, a structure made by tree_map."""
    if members is None:
        _get(tree, path[:-1])[path[-1]] = value
        return
    for m, v in zip(members, value.unbind(0)):
        _get(tree, m[:-1])[m[-1]] = v


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """v as a 0-dim f32 tensor on like's device."""
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def group_spec(specs, members, path):
    """The spec of a group's tensor (`group_tensor`): a layer stack's
    leaf gains its uncut [L] dim."""
    if specs is None:
        return None
    if members is None:
        return _get(specs, path)
    return (None,) + tuple(_get(specs, members[0]))


def _mean(x: torch.Tensor, dim: int | None, spec, *,
          keepdim: bool = False) -> torch.Tensor:
    """torch.mean of the whole tensor over `dim` (None: every dim), from
    this rank's block x cut by `spec`: where live axes cut that dim, the
    block's sum, summed over those axes in rank order, over the whole
    count."""
    dims = tuple(range(x.ndim)) if dim is None else (dim % x.ndim,)
    axes = () if spec is None else sharding.spec_axes(
        [spec[d] for d in dims])
    if not axes:
        return torch.mean(x) if dim is None \
            else torch.mean(x, dim=dim, keepdim=keepdim)
    s = torch.sum(x) if dim is None else torch.sum(x, dim=dim,
                                                   keepdim=keepdim)
    s = sharding.sum_over_ranks(s, axes)
    n = math.prod(x.shape[d] for d in dims) \
        * math.prod(sharding.axis_size(a) for a in axes)
    return s / _scalar(n, s)


# ---------------------------------------------------------------------------
# clip, apply
# ---------------------------------------------------------------------------
def _leaf_sums(sums: list, axes: list) -> list:
    """Each leaf's partial sum summed over its axes in rank order; the
    leaves cut over the same axes share one collective (a stacked vector,
    each entry added in the same order as alone)."""
    out = list(sums)
    for ax in dict.fromkeys(a for a in axes if a):
        idx = [i for i, a in enumerate(axes) if a == ax]
        total = sharding.sum_over_ranks(torch.stack([sums[i] for i in idx]),
                                        ax)
        for i, t in zip(idx, total.unbind(0)):
            out[i] = t
    return out


def global_norm_clip(grads, max_norm: float, specs=None):
    """(grads scaled by min(1, max_norm / max(‖g‖, 1e-9)) in f32 and cast
    back to each leaf's dtype, the global norm ‖g‖ as an f32 tensor).
    With the params' spec tree `specs` the leaves are blocks: each leaf's
    sum of squares over its block, summed over the axes that cut it (a
    whole leaf counts once), the leaves then added in tree order."""
    leaves = tree_leaves(grads)
    sums = [torch.sum(torch.square(g.float())) for g in leaves]
    if specs is not None:
        sums = _leaf_sums(sums, [sharding.spec_axes(s)
                                 for s in tree_leaves(specs)])
    gn = torch.sqrt(sum(sums))
    scale = torch.clamp(_scalar(max_norm, gn) / torch.clamp(gn, min=1e-9),
                        max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw(lr_fn: Callable[[torch.Tensor], torch.Tensor], *, b1=0.9, b2=0.95,
          eps=1e-8, weight_decay=0.01) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        dev = tree_leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, specs=None):
        # elementwise: blocks update as they are (specs unread)
        step = state["step"] + 1
        lr = lr_fn(step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.float()), state["v"], grads)
        s = step.float()
        bc1 = 1 - torch.pow(_scalar(b1, s), s)
        bc2 = 1 - torch.pow(_scalar(b2, s), s)
        upd = tree_map(
            lambda m_, v_, p: -lr * ((m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
                                     + weight_decay * p.float()),
            m, v, params)
        return upd, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------
def adafactor(lr_fn: Callable[[torch.Tensor], torch.Tensor], *, decay=0.8,
              eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0) -> Optimizer:
    """Momentum-free Adafactor (Shazeer & Stern 2018), factored statistics
    for the reference's leaves of two or more dims (every layer stack's).
    state["stats"] is keyed by the reference's leaf paths ({"vr", "vc"}
    or {"v"} per leaf)."""

    def init(params):
        stats: dict = {}
        for path, members in stacked_groups(params):
            p = _get(params, path if members is None else members[0])
            shape = tuple(p.shape) if members is None \
                else (len(members),) + tuple(p.shape)

            def zeros(sh):
                return torch.zeros(sh, dtype=torch.float32, device=p.device)

            node = stats
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = ({"vr": zeros(shape[:-1]),
                               "vc": zeros(shape[:-2] + shape[-1:])}
                              if len(shape) >= 2 else {"v": zeros(shape)})
        dev = tree_leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "stats": stats}

    def one(g, s, p, beta, lr, spec):
        """One reference leaf; `spec` cuts its block (None: whole)."""
        gf = g.float()
        g2 = torch.square(gf) + eps
        if "vr" in s:
            vr = beta * s["vr"] + (1 - beta) * _mean(g2, -1, spec)
            vc = beta * s["vc"] + (1 - beta) * _mean(g2, -2, spec)
            # vr's last dim is the leaf's second to last
            r = vr / torch.clamp(_mean(vr, -1, None if spec is None
                                       else spec[:-1], keepdim=True),
                                 min=eps)
            precond = gf / (torch.sqrt(r)[..., None]
                            * torch.sqrt(vc)[..., None, :])
            new_s = {"vr": vr, "vc": vc}
        else:
            v = beta * s["v"] + (1 - beta) * g2
            precond = gf / torch.sqrt(v)
            new_s = {"v": v}
        rms = torch.sqrt(_mean(torch.square(precond), None, spec) + 1e-12)
        precond = precond / torch.clamp(rms / _scalar(clip_threshold, rms),
                                       min=1.0)
        return -lr * (precond + weight_decay * p.float()), new_s

    def update(grads, state, params, specs=None):
        """specs: the params' spec tree where they are placed blocks."""
        step = state["step"] + 1
        lr = lr_fn(step)
        beta = 1.0 - torch.pow(step.float(), _scalar(-decay, lr))
        upd = tree_map(lambda p: None, params)
        stats: dict = {}
        for path, members in stacked_groups(params):
            u, new_s = one(group_tensor(grads, members, path),
                           _get(state["stats"], path),
                           group_tensor(params, members, path), beta, lr,
                           group_spec(specs, members, path))
            set_group(upd, members, path, u)
            node = stats
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = new_s
        return upd, {"step": step, "stats": stats}

    return Optimizer(init, update)
