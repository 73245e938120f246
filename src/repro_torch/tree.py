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


class _Leaf:
    """Marks a leaf's place in a ``flatten`` tree definition."""

    def __repr__(self):
        return "*"


_LEAF = _Leaf()


def flatten(tree, is_leaf=None):
    """Leaves of a tree of dicts, lists and tuples, with JAX's pytree
    conventions: dict keys in sorted order, ``None`` an empty subtree.
    Returns ([(path, leaf)], treedef); a path reads like JAX's ``keystr``
    (``['cache']['k']``), and ``unflatten(treedef, leaves)`` rebuilds the
    tree. ``is_leaf(node)`` stops the walk at a node."""
    out = []
    return out, _walk(tree, "", is_leaf, out)


# module-level recursion: a recursive closure would be a reference cycle
# holding the leaves until the garbage collector ran, and a pause must
# free the device tensors it flattened at once
def _walk(node, path, is_leaf, out):
    if is_leaf is not None and is_leaf(node):
        out.append((path, node))
        return _LEAF
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _walk(node[k], f"{path}[{k!r}]", is_leaf, out)
                for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, f"{path}[{i}]", is_leaf, out)
                          for i, v in enumerate(node))
    out.append((path, node))
    return _LEAF


def unflatten(treedef, leaves):
    """Inverse of ``flatten``: put ``leaves`` back in the tree's places."""
    return _build(treedef, iter(leaves))


def _build(d, it):
    if d is _LEAF:
        return next(it)
    if isinstance(d, dict):
        return {k: _build(v, it) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return type(d)(_build(v, it) for v in d)
    return d
