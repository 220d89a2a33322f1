"""Layouts the serving entry points run on."""

from .mesh import ShardMesh, make_shard_mesh

__all__ = ["ShardMesh", "make_shard_mesh"]
