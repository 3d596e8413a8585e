"""Param trees: nested dicts of tensors, the port's counterpart of pytrees."""
from __future__ import annotations

__all__ = ["tree_map", "tree_leaves", "flat_leaves", "unflatten"]


def tree_map(fn, *trees):
    """fn over the leaves of same-shaped nested dicts (in the first tree's
    key order)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """The leaves of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def flat_leaves(tree) -> list:
    """The leaves of a tree (nested dicts; a bare tensor is one leaf) in
    JAX's flattening order: dict keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flat_leaves(tree[k])]
    return [tree]


def unflatten(like, leaves: list):
    """``like``'s structure holding ``leaves`` (in ``flat_leaves`` order)."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            out = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # the caller's key order
        return next(it)

    return rebuild(like)
