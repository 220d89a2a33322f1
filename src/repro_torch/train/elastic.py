"""Elastic re-scaling: move (params, opt_state) between meshes.

Elasticity is the ability to continue a run on another device count or
topology.  The logical tree does not change; only where its leaves live
does.  ``reshard_tree`` evaluates the target rule at every leaf, checks
the spec against the target mesh as the reference's ``NamedSharding``
does (its axes must exist and divide the leaf's dims), and places the
leaf on the mesh's device with its dtype and bits unchanged.  On one card
that placement is the whole of a resize: a move between the card and the
host, or none.  Splitting a leaf across cards waits for a machine with
several.  As in the reference, **elastic resize == checkpoint save +
restore onto the new mesh**, minus the disk.

Trees are the optimizers' and checkpoints' (``train/tree.py``): dicts,
lists and NamedTuples, an optimizer state keeping its type; a model
enters through its ``tree()`` and leaves through ``load_tree``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.dist.sharding import P
from repro_torch.train.tree import tree_map_with_path

__all__ = ["check_spec", "reshard_tree", "resize_data_axis"]


def check_spec(spec: P, shape, mesh) -> None:
    """Raise ``ValueError`` where ``spec`` cannot place a leaf of
    ``shape`` on ``mesh``: more entries than dims, an axis the mesh lacks
    or named twice, or a dim its axes' product does not divide."""
    if not isinstance(spec, P):
        raise TypeError(f"a rule must return a P, got {spec!r}")
    shape = tuple(shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has {len(spec)} entries for a "
                         f"leaf of rank {len(shape)}")
    seen = set()
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        n = 1
        for ax in (axes if isinstance(axes, tuple) else (axes,)):
            if ax not in mesh.axis_names:
                raise ValueError(f"spec {spec} names axis {ax!r}, not in "
                                 f"the mesh's {tuple(mesh.axis_names)}")
            if ax in seen:
                raise ValueError(f"spec {spec} names axis {ax!r} twice")
            seen.add(ax)
            n *= int(mesh.shape[ax])
        if shape[dim] % n:
            raise ValueError(f"spec {spec} splits dim {dim} of a {shape} "
                             f"leaf {n} ways, which does not divide it")


def reshard_tree(tree: Any, mesh, rule: Callable[[tuple, Any], P]) -> Any:
    """Re-place every leaf on ``mesh`` with the spec ``rule(path, leaf)``.

    Each spec is checked against the leaf and the mesh; each leaf is then
    placed on ``mesh.device`` (a copy where it lives elsewhere, the same
    tensor where it is there already), its dtype and bits unchanged."""
    device = mesh.device

    def place(path, leaf):
        check_spec(rule(path, leaf), leaf.shape, mesh)
        return leaf.to(device)

    return tree_map_with_path(place, tree)


def resize_data_axis(tree: Any, old_mesh, new_mesh,
                     rule: Callable[[tuple, Any], P]) -> Any:
    """Continue a run on a resized mesh: the tree re-placed on
    ``new_mesh`` under ``rule`` (``old_mesh`` is where it lives now)."""
    return reshard_tree(tree, new_mesh, rule)
