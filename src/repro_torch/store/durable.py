"""Store façade + the write-through index wrapper.

:class:`Store` owns one durability directory (translog generations +
commit points) -- the per-index analogue of an ES data path.
:class:`DurableIndex` is the write-through discipline: it wraps a
:class:`~repro_torch.dist.shard_index.ShardedVectorIndex` so that every
``add_documents``/``delete`` hits the translog (fsync per the store's
durability policy) BEFORE the caller is acked -- ES
``index.translog.durability=request`` semantics, and in ES's order: the
op applies to the in-memory index FIRST and is logged only once it
succeeded, so a malformed op that raises (wrong feature count,
out-of-range id) is never logged and can never poison a later recovery
replay.  A crash between apply and log loses only an unacked op -- the
recovered state is exactly the acked history.

``DurableIndex`` follows the index's immutable idiom (every mutator
returns a new wrapper sharing the store) and carries ``translog_seq`` --
the seqno of the last op folded into this state, the commit metadata
that rides through ``BatchedSearchEngine.swap_index``.  Its
``add_documents`` takes no ``donate`` argument, so the serving engine
never donates a durable index's buffers (it donates only where the
index's ``add_documents`` names one).

``compact()`` and ``merge_segments()`` intentionally do NOT log:
maintenance changes no acked content (ids and df are preserved), so
recovery replaying the same ops over the pre-maintenance commit reaches
the same search state -- translog replay re-runs the identical
``add_documents`` history, which re-seals segments at identical
boundaries.  Commit right after a maintenance pass to re-anchor recovery
on the folded form and let the replayed translog trim.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.metrics import default_registry

from .recovery import recover
from .snapshot import _BlobMemo, latest_commit, write_commit
from .translog import Translog

__all__ = ["Store", "DurableIndex"]


class Store:
    """One durability directory: translog writer + commit points.

    ``commit`` and ``recover``/``recover_index`` serialize on an internal
    lock: a commit's translog trim and blob GC unlink files, which must
    never race a recovery scan that just listed them.

    **Observability**: commit and recovery wall times + counts record
    into ``metrics`` (the process's default registry unless one is
    given), and :meth:`stats` is the ES ``_stats/translog`` view --
    translog seqno/generation/on-disk bytes, newest commit
    generation/seq, commit + recovery timings.
    """

    def __init__(self, path: str, durability: str = "request",
                 metrics=None):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.translog = Translog(path, durability=durability)
        self.metrics = metrics if metrics is not None else default_registry()
        self._lock = threading.Lock()
        self._memo = _BlobMemo()           # entries of the parts committed

    @property
    def seqno(self) -> int:
        return self.translog.seqno

    @property
    def durability(self) -> str:
        return self.translog.durability

    def commit(self, index, seq: Optional[int] = None,
               stats: Optional[dict] = None) -> int:
        """Write a commit point for ``index`` (covering ``seq``, default
        the index's own ``translog_seq``), then roll the translog onto a
        fresh generation and trim generations the commit covers.
        ``stats`` (optional dict) receives ``write_commit``'s byte
        counts."""
        if seq is None:
            seq = getattr(index, "translog_seq", None)
            if seq is None:
                raise ValueError(
                    "index carries no translog_seq; pass seq= explicitly")
        t0 = time.monotonic()
        stats = {} if stats is None else stats
        with self._lock:
            # seq-only lookup: no point CRC-validating the fallback's data
            # here -- a corrupt fallback only makes the trim retain more
            prev = latest_commit(self.path, validate=False)
            # blob GC runs inside write_commit, under this lock
            gen = write_commit(self.path, index, seq, stats, self._memo)
            self.translog.roll()
            # retain translog back to the FALLBACK commit: if this
            # commit's data tears later, recovery falls back to `prev`
            # and still needs the ops between the two commit points
            self.translog.trim(prev.seq if prev is not None else 0)
        self.metrics.counter("store.commits").inc()
        self.metrics.histogram("store.commit.duration_s").observe(
            time.monotonic() - t0)
        # the O(changed) evidence: bytes actually written vs the bytes the
        # commit references (unchanged content-addressed blobs are shared)
        self.metrics.counter("store.commit.bytes_written").inc(
            stats["bytes_written"])
        self.metrics.gauge("store.commit.last_bytes_written").set(
            stats["bytes_written"])
        self.metrics.gauge("store.commit.last_bytes_total").set(
            stats["bytes_total"])
        return gen

    def has_commit(self) -> bool:
        # existence check only -- no point streaming a full-corpus CRC
        return latest_commit(self.path, validate=False) is not None

    def recover_index(self, device=None, *, mesh=None):
        """Crash-recover on ``mesh`` (or at one shard on ``device``, the
        card when neither is given) -> (raw index, seqno), serialized
        against concurrent commits (whose translog trim would otherwise
        unlink generation files out from under the replay scan)."""
        t0 = time.monotonic()
        with self._lock:
            out = recover(self.path, device, mesh=mesh)
        self.metrics.counter("store.recoveries").inc()
        self.metrics.histogram("store.recovery.duration_s").observe(
            time.monotonic() - t0)
        return out

    def recover(self, device=None, *,
                mesh=None) -> "Tuple[DurableIndex, int]":
        """Crash-recover on ``mesh`` or ``device`` -> (write-through
        wrapped index, seqno).  The wrapper's ``translog_seq`` resumes at the recovered
        position, so the next ingest logs at the right offset."""
        index, seq = self.recover_index(device, mesh=mesh)
        return DurableIndex(index, self, seq=seq), seq

    def open_index(self, index, *, allow_existing: bool = False,
                   stats: Optional[dict] = None) -> "DurableIndex":
        """Wrap a freshly built ``index`` for serving through this store
        and write its baseline commit point (a translog is only
        replayable on top of a commit).

        A store that ALREADY holds history refuses (``ValueError``):
        pairing a new index with an old commit would make every later
        recovery replay a different corpus than the one being served.
        Restarting on existing state is :meth:`recover`'s job.
        ``allow_existing=True`` opts out for callers that KNOW the index
        equals the stored state (a fresh baseline commit is then written
        on top, which is always consistent).  ``stats`` receives the
        baseline commit's byte counts."""
        if not allow_existing and (self.has_commit() or self.seqno):
            raise ValueError(
                f"store {self.path!r} already holds history (commit or "
                "translog ops); recover(device) instead of open_index, or "
                "pass allow_existing=True if this index provably equals "
                "the stored state")
        wrapped = DurableIndex(index, self, seq=self.seqno)
        self.commit(wrapped, stats=stats)
        return wrapped

    def stats(self) -> dict:
        """ES ``_stats/translog``-style snapshot (see
        :func:`repro_torch.obs.stats.store_stats`)."""
        from repro_torch.obs.stats import store_stats

        return store_stats(self)

    def close(self) -> None:
        self.translog.close()


class DurableIndex:
    """Write-through wrapper: memory first, translog second, then the ack.

    Transparent for reads (attribute access proxies to the wrapped index,
    so engines see ``search``/``n_ids``/``device``/... unchanged); the
    four mutators return a new wrapper sharing the store, with
    ``translog_seq`` advanced past the logged op.
    """

    def __init__(self, inner, store: Store, seq: Optional[int] = None):
        self.inner = inner
        self.store = store
        self.translog_seq = store.seqno if seq is None else seq

    def add_documents(self, vectors) -> "DurableIndex":
        # apply first (validation lives there), then log the float32 host
        # copy of exactly the rows applied -- replay re-runs the identical
        # normalize/encode for bit-exact recovery, and an op that raised
        # is never logged.  A tensor is applied where it lies (a card
        # batch stays on the card) and copied to the host for the log.
        if isinstance(vectors, torch.Tensor):
            v = vectors.detach().to(torch.float32)
            new = self.inner.add_documents(v)
            host = v.cpu().numpy()
        else:
            host = np.asarray(vectors, np.float32)
            new = self.inner.add_documents(host)
        seq = self.store.translog.add(host)
        return DurableIndex(new, self.store, seq)

    def delete(self, ids) -> "DurableIndex":
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        arr = np.atleast_1d(np.asarray(ids, np.int64))
        new = self.inner.delete(arr)
        seq = self.store.translog.delete(arr)
        return DurableIndex(new, self.store, seq)

    def compact(self) -> "DurableIndex":
        # not logged: content-preserving (see module docstring)
        return DurableIndex(self.inner.compact(), self.store,
                            self.translog_seq)

    def merge_segments(self, start: int = 0, count=None) -> "DurableIndex":
        # not logged, same reasoning as compact: a merge drops only
        # already-dead rows, so replaying the acked ops over the
        # pre-merge commit reaches the same search state
        return DurableIndex(self.inner.merge_segments(start, count),
                            self.store, self.translog_seq)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"DurableIndex(seq={self.translog_seq}, "
                f"store={self.store.path!r}, inner={self.inner!r})")
