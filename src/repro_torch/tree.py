"""Nested dicts of tensors as trees, walked in the reference's leaf order.

The reference's tree library visits a dict's entries in sorted-key order,
while the port's dicts keep insertion order; every walk here sorts the
keys, so sums over leaves (the global gradient norm) and the checkpoint's
key list follow the reference's order.
"""
from __future__ import annotations

__all__ = ["leaf_paths", "leaves", "get_leaf", "set_leaf"]


def leaf_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """``[(path, leaf), ...]`` in sorted-key order; a path is the tuple of
    dict keys (list and tuple entries by index) from the root to the leaf."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [pl for k, v in items for pl in leaf_paths(v, prefix + (k,))]


def leaves(tree) -> list:
    """The leaves of ``tree`` in sorted-key order."""
    return [leaf for _, leaf in leaf_paths(tree)]


def get_leaf(tree, path: tuple):
    """The leaf at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def set_leaf(tree, path: tuple, value) -> None:
    """Replace the leaf at ``path`` of a tree of dicts and lists in place."""
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value
