"""Doc-sharded search with the segment lifecycle (ingest, seal, delete,
merge, compact), S doc-shards x R replica groups on one device.

The layout is a :class:`repro_torch.launch.mesh.ShardMesh`; its axes are
named by :mod:`repro_torch.dist.sharding`.
"""

from .shard_index import DEFAULT_SEAL_THRESHOLD, Segment, ShardedVectorIndex
from .sharding import DATA_AXIS, REPLICA_AXIS

__all__ = ["ShardedVectorIndex", "Segment", "DEFAULT_SEAL_THRESHOLD",
           "DATA_AXIS", "REPLICA_AXIS"]
