"""Layouts: the serving entry points' shard meshes and the model
families' meshes (the production pods, a local grid)."""

from .mesh import (DeviceMesh, ShardMesh, make_local_mesh, make_production_mesh,
                   make_shard_mesh)

__all__ = ["ShardMesh", "make_shard_mesh", "DeviceMesh", "make_production_mesh",
           "make_local_mesh"]
