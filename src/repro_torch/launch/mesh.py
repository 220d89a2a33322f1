"""The layout of doc-sharded search: S doc-shards x R replica groups.

A :class:`ShardMesh` is the reference's ``(data, replica)`` device mesh
as a plain grid: ``devices[s][r]`` holds doc-shard ``s`` of replica group
``r``.  One Python process drives every cell, as the reference's single
controller drives its mesh, so a caller's API does not change with the
layout.  Here every cell is one device: an index's shards are slices of
one tensor and its replica groups share those tensors, so R groups cost
no memory.  Placement on several cards waits for a machine that has them.

A :class:`DeviceMesh` is the reference's model-family mesh, named axes
and their sizes: :func:`make_production_mesh` gives the 16 x 16 ``(data,
model)`` pod and the 2 x 16 x 16 ``(pod, data, model)`` pair of pods as
abstract meshes (no devices: the dry run reads their shapes), and
:func:`make_local_mesh` a ``(data, model)`` grid on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.dist.sharding import DATA_AXIS, MODEL_AXIS, REPLICA_AXIS

__all__ = ["ShardMesh", "make_shard_mesh", "DeviceMesh",
           "make_production_mesh", "make_local_mesh"]


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """An (S, R) grid of devices: doc-shards along ``data``, replica
    groups along ``replica``."""

    devices: Tuple[Tuple[torch.device, ...], ...]   # (S, R)

    def __post_init__(self):
        if not self.devices or not self.devices[0]:
            raise ValueError("a mesh needs at least one shard and one group")
        if len({len(row) for row in self.devices}) != 1:
            raise ValueError("every shard needs the same number of groups")

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def n_replicas(self) -> int:
        return len(self.devices[0])

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """``("data",)``, or ``("data", "replica")`` with more than one
        group: the reference keeps its one-group mesh 1-D."""
        if self.n_replicas == 1:
            return (DATA_AXIS,)
        return (DATA_AXIS, REPLICA_AXIS)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_shards, REPLICA_AXIS: self.n_replicas}

    @property
    def device(self) -> torch.device:
        """The one device every cell is on; raises for a grid that spans
        several."""
        cells = {d for row in self.devices for d in row}
        if len(cells) != 1:
            raise ValueError(f"the mesh spans {len(cells)} devices; an "
                             "index is placed on one")
        return next(iter(cells))

    def column(self, g: int) -> "ShardMesh":
        """Replica group ``g`` as a one-group mesh of its S cells."""
        if not 0 <= g < self.n_replicas:
            raise ValueError(f"replica group must be in [0, "
                             f"{self.n_replicas}), got {g}")
        return ShardMesh(tuple((row[g],) for row in self.devices))


def make_shard_mesh(n_shards: int, n_replicas: int = 1,
                    device="cuda") -> ShardMesh:
    """S doc-shards x R replica groups, every cell on ``device`` (the card
    unless the caller asks for the CPU)."""
    if int(n_shards) < 1 or int(n_replicas) < 1:
        raise ValueError(f"need at least one shard and one replica, got "
                         f"{n_shards} x {n_replicas}")
    dev = torch.device(device)
    return ShardMesh(tuple((dev,) * int(n_replicas)
                           for _ in range(int(n_shards))))


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Named mesh axes and their sizes, over ``devices`` (none for an
    abstract mesh)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def device(self) -> torch.device:
        """The one device every cell is on; raises for an abstract mesh
        and for one that spans several devices."""
        if len(set(self.devices)) != 1:
            raise ValueError(f"the mesh {self.shape} spans "
                             f"{len(set(self.devices)) or 'no'} devices; a "
                             "tensor is placed on one")
        return self.devices[0]


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The 16 x 16 ``(data, model)`` pod, or 2 x 16 x 16 ``(pod, data,
    model)``: abstract, for the dry run's per-device accounting."""
    if multi_pod:
        return DeviceMesh(("pod", DATA_AXIS, MODEL_AXIS), (2, 16, 16))
    return DeviceMesh((DATA_AXIS, MODEL_AXIS), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1,
                    device="cuda") -> DeviceMesh:
    """A ``(data, model)`` grid on one ``device`` (the card unless the
    caller asks for the CPU): one cell, as the reference's grid over the
    devices that exist."""
    if int(data) < 1 or int(model) < 1:
        raise ValueError(f"need at least one cell, got {data} x {model}")
    if int(data) * int(model) > 1:
        raise ValueError(f"a {data} x {model} grid needs {data * model} "
                         "devices; a local mesh has one")
    dev = torch.device(device)
    return DeviceMesh((DATA_AXIS, MODEL_AXIS), (int(data), int(model)),
                      (dev,))
