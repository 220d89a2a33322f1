"""Batched request serving for the vector-search index.

Incoming query vectors are buffered until ``batch_size`` requests or
``max_wait_s`` after the OLDEST queued request (whichever first), padded
to the fixed batch shape, handed to ONE ``index.search`` as a CPU tensor
(the index moves it to its own device), and scattered back to their futures as numpy arrays.  Batch 1 is
the lowest latency; batch N trades latency for N-fold throughput.

The engine is index-polymorphic: anything with the ``VectorIndex.search``
contract serves, in particular
:class:`repro_torch.dist.shard_index.ShardedVectorIndex`, which also takes
``merge=`` and ``max_postings="auto"`` (passed on only when set).

**Hot ingest**: ``add_documents`` and ``delete`` go through the index's own
methods and swap the new index in under the engine lock: the batch in
flight finishes on its snapshot, every later batch sees the change.  With
``donate_ingest=True`` an ingest batch may be written into the active
buffer in place (``add_documents(..., donate=True)``), but only while no
batch is in flight (``_serving`` is None): the snapshot it searches may
be the current index, or share its buffers (a delete or a merge keeps
the active buffer), and may still be reading them.

Lifecycle: ``submit`` after ``close`` raises ``RuntimeError``; a search
that raises inside the worker fails only that batch's futures and the
worker keeps serving; ``close`` drains everything already queued.
``swap_index(new, expected=old)`` is a compare-and-swap of the served
index (a batch in flight finishes on its snapshot), and ``pending``
(queued + in-flight) is a router's load signal.
"""

from __future__ import annotations

import inspect
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import TrimFilter

__all__ = ["BatchedSearchEngine"]


class BatchedSearchEngine:
    def __init__(
        self,
        index,                      # VectorIndex or anything with .search
        batch_size: int = 32,
        max_wait_s: float = 0.005,
        k: int = 10,
        page: int = 320,
        trim: Optional[TrimFilter] = TrimFilter(0.05),
        engine: str = "codes",
        merge: Optional[str] = None,
        max_postings: "Optional[int | str]" = None,
        donate_ingest: bool = False,
    ):
        self.index = index
        self.batch_size = batch_size
        self.max_wait_s = max_wait_s
        self.k, self.page, self.trim, self.engine = k, page, trim, engine
        # None omits the argument, so an index without it keeps serving
        self.merge = merge
        self.max_postings = max_postings
        self.donate_ingest = donate_ingest
        self._serving = None               # the in-flight batch's snapshot
        self._lock = threading.Condition()
        self._queue: List[tuple] = []      # (query, future, enqueue time)
        self._stop = False
        self._inflight = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ API
    def submit(self, query_vec) -> Future:
        """Queue one query -> Future of (ids, scores) numpy arrays."""
        fut: Future = Future()
        with self._lock:
            if self._stop:
                raise RuntimeError("engine closed")
            self._queue.append((np.asarray(query_vec, np.float32), fut,
                                time.monotonic()))
            self._lock.notify()
        return fut

    def search(self, query_vec, timeout: float = 10.0):
        return self.submit(query_vec).result(timeout=timeout)

    @property
    def pending(self) -> int:
        """Queued + in-flight request count."""
        with self._lock:
            return len(self._queue) + self._inflight

    def add_documents(self, vectors) -> int:
        """Hot-add documents through the index's ``add_documents`` -> the
        first global id assigned; raises ``TypeError`` for an index without
        incremental ingest.  With ``donate_ingest`` the batch is donated
        when no batch is in flight."""
        with self._lock:
            if self._stop:
                raise RuntimeError("engine closed")
            add = getattr(self.index, "add_documents", None)
            if add is None:
                raise TypeError(
                    f"{type(self.index).__name__} does not support "
                    "incremental ingest; serve a ShardedVectorIndex")
            first_id = self.index.n_ids
            donate = (self.donate_ingest and self._serving is None
                      and "donate" in inspect.signature(add).parameters)
            self.index = (add(vectors, donate=True) if donate
                          else add(vectors))
        return first_id

    def delete(self, ids) -> None:
        """Hot-tombstone documents through the index's ``delete``; raises
        ``TypeError`` for an index without deletes."""
        with self._lock:
            if self._stop:
                raise RuntimeError("engine closed")
            delete = getattr(self.index, "delete", None)
            if delete is None:
                raise TypeError(
                    f"{type(self.index).__name__} does not support deletes; "
                    "serve a ShardedVectorIndex")
            self.index = delete(ids)

    def swap_index(self, new_index, expected=None) -> bool:
        """Atomically replace the served index.  With ``expected`` this is
        a compare-and-swap: the flip happens only while ``self.index is
        expected``, else it returns False and the caller retries."""
        with self._lock:
            if self._stop:
                raise RuntimeError("engine closed")
            if expected is not None and self.index is not expected:
                return False
            self.index = new_index
        return True

    def close(self):
        with self._lock:
            self._stop = True
            self._lock.notify()
        self._worker.join()

    # --------------------------------------------------------------- worker
    def _next_batch(self):
        """Wait for a full batch, or for the oldest request's deadline;
        -> (batch, index snapshot), or None once closed and drained."""
        with self._lock:
            while len(self._queue) < self.batch_size and not self._stop:
                now = time.monotonic()
                if self._queue:
                    deadline = self._queue[0][2] + self.max_wait_s
                    if now >= deadline:
                        break
                    self._lock.wait(timeout=deadline - now)
                else:
                    self._lock.wait(timeout=self.max_wait_s)
            if self._stop and not self._queue:
                return None
            batch = self._queue[: self.batch_size]
            del self._queue[: len(batch)]
            # a hot swap after this point applies to the NEXT batch; a
            # donating ingest must not write into the snapshot's buffers
            self._inflight = len(batch)
            self._serving = self.index if batch else None
            return batch, self.index

    def _search(self, index, batch):
        qs = np.stack([it[0] for it in batch])
        pad = self.batch_size - qs.shape[0]
        if pad:
            qs = np.concatenate([qs, np.zeros((pad, qs.shape[1]), qs.dtype)])
        kwargs = {"merge": self.merge} if self.merge else {}
        if self.max_postings is not None:
            kwargs["max_postings"] = self.max_postings
        # the index puts the batch on its own device
        ids, scores = index.search(
            torch.from_numpy(qs), k=self.k, page=self.page, trim=self.trim,
            engine=self.engine, **kwargs)
        return np.asarray(torch.as_tensor(ids).cpu()), \
            np.asarray(torch.as_tensor(scores).cpu())

    def _run(self):
        while True:
            got = self._next_batch()
            if got is None:
                return
            batch, index = got
            if not batch:
                continue
            try:
                # a failing search fails only this batch's futures
                try:
                    ids, scores = self._search(index, batch)
                except Exception as exc:  # noqa: BLE001 - fwd to futures
                    for _, fut, _ in batch:
                        if not fut.done():
                            fut.set_exception(exc)
                    continue
                for i, (_, fut, _) in enumerate(batch):
                    if not fut.done():      # caller may have cancelled
                        fut.set_result((ids[i], scores[i]))
            finally:
                with self._lock:
                    self._inflight = 0
                    self._serving = None
