"""Trees of tensors in JAX's flatten order.

The optimizers, the train step and the checkpoints work on the
reference's trees: nested dicts (visited by sorted key), lists, tuples and
NamedTuples (in order), ``None`` holding no leaf.  So a checkpoint's leaf
``i`` is the JAX package's leaf ``i``.  A model (``nn.Module``) enters a
tree through its ``tree()`` method and leaves it through ``load_tree``.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple

import torch

__all__ = ["tree_leaves", "tree_map", "tree_map_with_path", "as_tree",
           "load_tree", "DictKey", "SequenceKey", "GetAttrKey"]


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
    return tree_map_with_path(lambda _path, *leaves: fn(*leaves), tree, *rest)


def as_tree(params):
    """A model's reference tree (its ``tree()``), or ``params`` itself."""
    return params.tree() if isinstance(params, torch.nn.Module) else params


def load_tree(params, tree):
    """Write ``tree`` into a model (in place) -> the model; a tree is
    simply replaced."""
    if isinstance(params, torch.nn.Module):
        return params.load_tree(tree)
    return tree


# ----------------------------------------------------------------- paths
class DictKey(NamedTuple):
    """A dict entry on a leaf's path (JAX's ``DictKey``: ``.key``)."""
    key: Any


class SequenceKey(NamedTuple):
    """A list or tuple position on a leaf's path (``.idx``)."""
    idx: int


class GetAttrKey(NamedTuple):
    """A NamedTuple field on a leaf's path (``.name``)."""
    name: str


def _path_keys(t) -> list:
    if isinstance(t, dict):
        return [DictKey(k) for k in sorted(t)]
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return [GetAttrKey(f) for f in t._fields]
    return [SequenceKey(i) for i in range(len(t))]


def tree_map_with_path(fn: Callable, tree, *rest):
    """``fn(path, leaf, *others)`` over the leaves of ``tree`` in JAX's
    flatten order; ``path`` is a tuple of :class:`DictKey`,
    :class:`SequenceKey` and :class:`GetAttrKey`, as JAX's key paths."""
    def go(path, t, others):
        if t is None:
            return None
        kids = _children(t)
        if kids is None:
            return fn(path, t, *others)
        subs = [_children(o) for o in others]
        keys = _path_keys(t)
        return _rebuild(t, [go(path + (keys[i],), k, [s[i] for s in subs])
                            for i, k in enumerate(kids)])
    return go((), tree, rest)
