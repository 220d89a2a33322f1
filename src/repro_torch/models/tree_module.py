"""A model held as the JAX package's parameter tree.

The reference's recsys and GNN models are pure functions of a nested
dict / list tree of arrays.  :class:`TreeModule` keeps that tree, each
leaf an ``nn.Parameter`` registered under its path, so the port's
forward functions read it as the reference's do (``params["cin"][0]``),
and :meth:`TreeModule.tree` / :meth:`TreeModule.load_tree` hand the same
tree to the optimizers, the train step and the checkpoints (leaf order:
``repro_torch.train.tree``, JAX's flatten order).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..train.tree import tree_map

__all__ = ["TreeModule", "params_of"]


class TreeModule(nn.Module):
    """``cfg`` and the parameter tree ``tree`` (nested dicts and lists of
    float tensors, taken as the parameters' storage)."""

    def __init__(self, cfg, tree):
        super().__init__()
        self.cfg = cfg
        self.params = self._wrap(tree, ())

    def _wrap(self, t, path):
        if isinstance(t, dict):
            return {k: self._wrap(v, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [self._wrap(v, path + (str(i),)) for i, v in enumerate(t)]
        p = nn.Parameter(t)
        self.register_parameter("__".join(path), p)
        return p

    def tree(self, grads: bool = False) -> Any:
        """The reference's tree (detached leaves; ``grads=True`` their
        gradients, zeros where a leaf got none, as ``jax.grad`` gives)."""
        if grads:
            return tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                            else p.grad, self.params)
        return tree_map(lambda p: p.detach(), self.params)

    @torch.no_grad()
    def load_tree(self, tree) -> "TreeModule":
        """Copy a tree of the reference's structure into the parameters."""
        tree_map(lambda p, t: p.copy_(t), self.params, tree)
        return self


def params_of(params):
    """The parameter tree a forward function reads: a :class:`TreeModule`'s
    (live parameters, so gradients reach them) or a plain tree itself."""
    return params.params if isinstance(params, TreeModule) else params
