"""The layout of doc-sharded search: S doc-shards x R replica groups.

A :class:`ShardMesh` is the reference's ``(data, replica)`` device mesh
as a plain grid: ``devices[s][r]`` holds doc-shard ``s`` of replica group
``r``.  One Python process drives every cell, as the reference's single
controller drives its mesh, so a caller's API does not change with the
layout.  Here every cell is one device: an index's shards are slices of
one tensor and its replica groups share those tensors, so R groups cost
no memory.  Placement on several cards waits for a machine that has them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.dist.sharding import DATA_AXIS, REPLICA_AXIS

__all__ = ["ShardMesh", "make_shard_mesh"]


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
