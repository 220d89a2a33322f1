"""Doc-sharded search with the segment lifecycle (ingest, seal, delete,
merge, compact), at one shard on one device."""

from .shard_index import DEFAULT_SEAL_THRESHOLD, Segment, ShardedVectorIndex

__all__ = ["ShardedVectorIndex", "Segment", "DEFAULT_SEAL_THRESHOLD"]
