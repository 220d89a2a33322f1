"""Trees of tensors in JAX's flatten order.

The optimizers, the train step and the checkpoints work on the
reference's trees: nested dicts (visited by sorted key), lists, tuples and
NamedTuples (in order), ``None`` holding no leaf.  So a checkpoint's leaf
``i`` is the JAX package's leaf ``i``.  A model (``nn.Module``) enters a
tree through its ``tree()`` method and leaves it through ``load_tree``.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch

__all__ = ["tree_leaves", "tree_map", "as_tree", "load_tree"]


def _children(t):
    if isinstance(t, dict):
        return [t[k] for k in sorted(t)]
    if isinstance(t, (list, tuple)):
        return list(t)
    return None


def _rebuild(t, children):
    if isinstance(t, dict):
        return dict(zip(sorted(t), children))
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*children)
    return type(t)(children)


def tree_leaves(tree) -> List[Any]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for k in kids for leaf in tree_leaves(k)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``
    (trees of ``tree``'s structure)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    return _rebuild(tree, [tree_map(fn, k, *(o[i] for o in others))
                           for i, k in enumerate(kids)])


def as_tree(params):
    """A model's reference tree (its ``tree()``), or ``params`` itself."""
    return params.tree() if isinstance(params, torch.nn.Module) else params


def load_tree(params, tree):
    """Write ``tree`` into a model (in place) -> the model; a tree is
    simply replaced."""
    if isinstance(params, torch.nn.Module):
        return params.load_tree(tree)
    return tree
