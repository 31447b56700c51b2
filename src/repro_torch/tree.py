"""Nested-dict trees (the port's pytrees) in ``jax.tree.flatten`` order.

Parameters, gradients and optimizer state are nested dicts whose leaves are
tensors or QTensors. The reference splits one PRNG key per leaf in
``jax.tree.flatten`` order — dict keys sorted — so every per-leaf draw here
walks the same order to land on the same leaf."""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """Leaves of a nested-dict tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested-dict trees of one structure, visited
    in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)
