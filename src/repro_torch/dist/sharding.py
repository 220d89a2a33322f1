"""The axis names of the doc-sharded search layout.

``data`` partitions the corpus into contiguous doc-shards; ``replica``
holds R serving copies of every shard, across which query batches
round-robin -- a pure QPS axis, never a placement one.  The parameter
sharding rules of the reference's module serve its model code, which
this package has not ported.
"""

DATA_AXIS = "data"
REPLICA_AXIS = "replica"

__all__ = ["DATA_AXIS", "REPLICA_AXIS"]
