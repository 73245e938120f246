"""Nested-dict trees: the port's stand-in for JAX pytrees.

Parameter, cache and state trees are plain nested dicts with tensors (or
numpy arrays) at the leaves, keyed exactly as in the JAX package.
"""
from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over one or more trees of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_items(tree, prefix=()):
    """(path tuple, leaf) pairs in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, prefix + (k,))
    else:
        yield prefix, tree


def tree_to(tree, device, copy: bool = False):
    """Move every tensor leaf to ``device``; with ``copy`` every leaf is a
    fresh tensor even where it already lives there."""
    return tree_map(lambda t: t.to(device, copy=copy)
                    if isinstance(t, torch.Tensor) else t, tree)
