"""Param trees: nested dicts of tensors, the port's counterpart of pytrees."""
from __future__ import annotations

__all__ = ["tree_map", "tree_leaves"]


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
