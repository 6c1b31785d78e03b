"""Trees of tensors: nested dicts and lists, walked in the order
jax.tree.leaves gives (dict keys sorted, lists in order). A spec tree
(`parallel.sharding`) is such a tree whose leaves are spec tuples."""
from __future__ import annotations


def tree_map(f, tree, *rest):
    """f over the tensor leaves of `tree` (dicts and lists), with the
    matching leaves of `rest`, into a tree of the same structure; leaves
    are visited in `tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(f, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return f(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensor leaves, dict keys in sorted order (as jax.tree.leaves
    orders them), layer lists in layer order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
