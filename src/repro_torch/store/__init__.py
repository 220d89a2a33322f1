"""Durability subsystem: translog, commit points, crash recovery.

The paper's pitch is that a vector database hosted in a fulltext engine
inherits Elasticsearch's "robustness, stability, scalability".  This
package is that durability pillar for the one-shard index of
:mod:`repro_torch.dist`: without it a process restart loses every index,
ingest and compaction.  Its files are the JAX package's
(``repro.store``) byte for byte -- translog generations, RSEG blobs and
manifests -- so either package recovers the other's store.  Every
component maps onto an ES/Lucene concept:

===============================  ==========================================
this package                     Elasticsearch / Lucene analogue
===============================  ==========================================
:class:`Translog`                the shard transaction log
(:mod:`~repro_torch.store.       (``index.translog``): framed, crc32'd,
translog`)                       sequence-numbered add/delete records,
                                 fsync'd per ``durability`` ("request" =
                                 fsync before ack, "async" = buffered);
                                 generation files rolled at each commit
                                 and trimmed once covered.  Deviation:
                                 operation-scoped, not per-shard --
                                 round-robin ingest routing is a pure
                                 function of the append counter, so one
                                 global op stream reproduces the index
                                 on any shard count.
commit points                    a Lucene commit (``segments_N``) run
(:mod:`~repro_torch.store.       through the ES *incremental snapshot*
snapshot`)                       model: the index splits into
                                 content-addressed blob files (base
                                 vectors / base state / active buffer /
                                 one per sealed segment) named by a
                                 digest of their bytes, so a part
                                 unchanged since the last commit is
                                 *referenced again* instead of
                                 rewritten -- commits are O(changed),
                                 not O(index).  Blobs are hashed and
                                 written a chunk at a time, never joined
                                 in host memory.  The manifest's atomic
                                 rename IS the commit; ``latest_commit``
                                 falls back a generation when any
                                 referenced blob is damaged; retention
                                 GC deletes only blobs NO retained
                                 manifest references (never the
                                 fallback's), under the store lock.
                                 ``restore`` rebuilds the index on a
                                 mesh of S shards x R groups from a
                                 writer of ANY shard count -- ES
                                 snapshot/restore into a differently
                                 sized cluster -- by host re-placement
                                 and one copy per leaf.
:func:`recover`                  peer-less shard recovery: open the
(:mod:`~repro_torch.store.       newest commit, truncate the translog's
recovery`)                       torn tail, replay ops past the commit's
                                 seqno through the live ingest code paths
                                 on the mesh -- the recovered index is
                                 bit-identical to the lost one.
:class:`Store` /                 the shard data path + the write-through
:class:`DurableIndex`            discipline: apply in memory, translog
(:mod:`~repro_torch.store.       append (fsync per policy), THEN ack --
durable`)                        an acked op survives the process, and a
                                 raising op is never logged (it cannot
                                 poison recovery); ``translog_seq`` rides
                                 each immutable index state through hot
                                 swaps as the commit metadata.
===============================  ==========================================

Entry points take ``mesh=`` (a
:class:`repro_torch.launch.mesh.ShardMesh`) where the JAX package's take a
mesh, or ``device=`` alone for one shard (``"cuda"`` unless the caller
asks for ``"cpu"``).
"""

from repro_torch.store.durable import DurableIndex, Store
from repro_torch.store.recovery import NoCommitError, recover
from repro_torch.store.snapshot import (CommitPoint, latest_commit, restore,
                                        write_commit)
from repro_torch.store.translog import (OP_ADD, OP_DELETE, Translog,
                                        TranslogCorruptedError, read_ops)

__all__ = [
    "Store", "DurableIndex", "Translog", "TranslogCorruptedError",
    "CommitPoint", "write_commit", "latest_commit", "restore", "recover",
    "NoCommitError", "read_ops", "OP_ADD", "OP_DELETE",
]
