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

**CUDA graphs** (:mod:`repro_torch.serve.graphs`): on a card, a fused
engine's batch without a profiled request is answered by replaying a
graph of the search, captured at the second batch each index instance
serves; the first batch of an instance, and every other batch, runs
eagerly.  The answers are the eager search's, bit for bit.

Lifecycle: ``submit`` after ``close`` raises ``RuntimeError``; a search
that raises inside the worker fails only that batch's futures and the
worker keeps serving; ``close`` drains everything already queued.
``swap_index(new, expected=old)`` is a compare-and-swap of the served
index (a batch in flight finishes on its snapshot), and ``pending``
(queued + in-flight) is a router's load signal.

**Observability** (:mod:`repro_torch.obs`), as the reference threads it:
request counters, batch occupancy, queue wait, dispatch latency, the
``engine.kernel_path`` counter, the ``postings`` walk's counters
``search.postings.entries``, ``.tokens`` and ``.rounds`` (summed by a
:class:`~repro_torch.core.postings.WalkTally` around each batch's search,
from host integers the walk already holds), the page selection's
``search.page_select.rows{engine}`` (the batch's difference of
:func:`~repro_torch.core.search.page_rows`) and the ingest series go to a
:class:`~repro_torch.obs.metrics.MetricsRegistry` (labelled ``group=g``
when the engine fronts one replica group); ``queue_wait`` /
``batch_form`` / ``dispatch`` spans go to the request's
:class:`~repro_torch.obs.tracing.Trace` (from ``tracer`` / ``slowlog``)
before its future resolves; ``submit(..., profile=True)`` resolves to
``(ids, scores, profile_dict)``, a per-request root over the batch's one
shared ``dispatch`` node, its three phases cut from shared clock reads
so they tile the root; the dispatch, ingest and delete run in
``compile_watch`` regions, and the dispatch in a
``torch.profiler.record_function`` range when the tracer annotates.
While a ``torch.profiler`` session records, the worker writes its loop
to the registry's timeline (:class:`~repro_torch.obs.tracing.Timeline`)
as five spans a batch that tile it -- ``batcher.wait``,
``batcher.form``, ``search.launch``, ``search.answer_wait``,
``batcher.deliver`` -- from the same clock reads as the histograms, and
sets a sink on its thread around the search and around an add, under
which the index records its phases and ``ingest.add`` its seal; every
batch draws a batch id, which its requests' trace spans carry as
``batch``.  All of it is host-side: the answers are bit-identical with
the plane on or off, and a request without a profile adds no device
synchronisation.
``stats()`` is the ES ``_cat/thread_pool`` view of this engine.
"""

from __future__ import annotations

import contextlib
import inspect
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import TrimFilter
from repro_torch.core.postings import WalkTally
from repro_torch.core.search import page_rows
from repro_torch.obs.compile_watch import active_watch
from repro_torch.obs.metrics import default_registry
from repro_torch.obs.profile import ProfileNode
from repro_torch.obs.slowlog import start_request_trace
from repro_torch.obs.tracing import annotation, to_ns
from repro_torch.serve.graphs import SearchGraphs

__all__ = ["BatchedSearchEngine"]

_NO_SINK = contextlib.nullcontext()


def _accepts_profile(index) -> bool:
    """Whether ``index.search`` takes the ``profile`` argument (the engine
    serves anything with a ``search``; ``**kwargs`` wrappers count -- they
    forward to an index that does)."""
    try:
        params = inspect.signature(index.search).parameters
    except (TypeError, ValueError):
        return False
    return "profile" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


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
        metrics=None,
        tracer=None,
        group: Optional[int] = None,
        donate_ingest: bool = False,
        slowlog=None,
        compile_watch=None,
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
        self.metrics = metrics if metrics is not None else default_registry()
        self.tracer = tracer
        self.slowlog = slowlog
        self.compile_watch = (compile_watch if compile_watch is not None
                              else active_watch())
        self.group = group
        self._metric_labels = {} if group is None else {"group": group}
        lb = self._metric_labels
        self._c_submitted = self.metrics.counter(
            "engine.requests.submitted", **lb)
        self._c_completed = self.metrics.counter(
            "engine.requests.completed", **lb)
        self._c_failed = self.metrics.counter("engine.requests.failed", **lb)
        self._h_occupancy = self.metrics.histogram(
            "engine.batch.occupancy", **lb)
        self._h_wait = self.metrics.histogram("engine.queue.wait_s", **lb)
        self._h_dispatch = self.metrics.histogram(
            "engine.dispatch.latency_s", **lb)
        self._c_kernel_path = self.metrics.counter(
            "engine.kernel_path", engine=self.engine, **lb)
        self._graphs = SearchGraphs(self.metrics, **lb)
        self._c_walk_entries = self.metrics.counter(
            "search.postings.entries", **lb)
        self._c_walk_tokens = self.metrics.counter(
            "search.postings.tokens", **lb)
        self._c_walk_rounds = self.metrics.counter(
            "search.postings.rounds", **lb)
        self._c_page_rows = self.metrics.counter(
            "search.page_select.rows", engine=self.engine, **lb)
        self._lock = threading.Condition()
        # (query, future, enqueue time, trace, want profile)
        self._queue: List[tuple] = []
        self._stop = False
        self._inflight = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ API
    def submit(self, query_vec, trace=None, profile: bool = False) -> Future:
        """Queue one query -> Future of (ids, scores) numpy arrays, or of
        (ids, scores, profile_dict) with ``profile=True``.  ``trace`` is an
        optional :class:`~repro_torch.obs.tracing.Trace` the worker
        appends its spans to; without one, an engine with a ``tracer`` or
        ``slowlog`` admits its own and finishes it when the future
        resolves."""
        fut: Future = Future()
        if trace is None and (self.tracer is not None
                              or self.slowlog is not None):
            trace = start_request_trace(self.tracer, self.slowlog, "query")
            if trace:
                t = trace
                fut.add_done_callback(
                    lambda f: t.finish(
                        error=None if f.cancelled() or f.exception()
                        is None else repr(f.exception())))
        with self._lock:
            if self._stop:
                raise RuntimeError("engine closed")
            self._queue.append((np.asarray(query_vec, np.float32), fut,
                                time.monotonic(), trace, profile))
            self._lock.notify()
        self._c_submitted.inc()
        return fut

    def search(self, query_vec, timeout: float = 10.0,
               profile: bool = False):
        return self.submit(query_vec, profile=profile).result(
            timeout=timeout)

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
            tl = self.metrics.timeline
            sink = tl.sink(group=self.group) if tl.recording() else None
            t0 = time.monotonic()
            with self.compile_watch.region("engine.ingest",
                                           sig=(tuple(np.shape(vectors)),)):
                with sink or _NO_SINK:
                    self.index = (add(vectors, donate=True) if donate
                                  else add(vectors))
            t1 = time.monotonic()
            latency = t1 - t0
            if sink is not None:
                tl.record("ingest.add", to_ns(t0), to_ns(t1),
                          span=sink.parent, group=sink.group)
        # the stall submits see: measured inside the lock
        self.metrics.histogram("engine.ingest.latency_s",
                               **self._metric_labels).observe(latency)
        self.metrics.counter("engine.ingest.added_docs",
                             **self._metric_labels).inc(
            len(vectors))
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
            t0 = time.monotonic()
            with self.compile_watch.region(
                    "engine.delete", sig=(torch.as_tensor(ids).numel(),)):
                self.index = delete(ids)
            latency = time.monotonic() - t0
        self.metrics.histogram("engine.ingest.latency_s",
                               **self._metric_labels).observe(latency)
        self.metrics.counter("engine.ingest.delete_ops",
                             **self._metric_labels).inc()

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
        self.metrics.counter("engine.swaps", **self._metric_labels).inc()
        return True

    def stats(self) -> dict:
        """ES ``_cat/thread_pool``-style snapshot of this engine: queue
        depth, in-flight count, request counters, occupancy, queue-wait
        and dispatch-latency histograms, ingest counters, kernel-path mix,
        the served index's doc/segment stats, and the slow-log and
        build-watch sections (:func:`repro_torch.obs.stats.engine_stats`).
        """
        from repro_torch.obs.stats import engine_stats

        return engine_stats(self)

    def node_stats(self) -> dict:
        """ES ``GET _nodes/stats``: per-device residency of the served
        index (see :func:`repro_torch.obs.stats.node_stats`)."""
        from repro_torch.obs.stats import node_stats

        return node_stats(self)

    def device_stats(self) -> dict:
        """Exact index-resident byte accounting for the served index --
        per leaf, per section, per device, reconciled against the
        allocator (see :func:`repro_torch.obs.device.device_bytes`)."""
        from repro_torch.obs.device import device_bytes

        return device_bytes(self.index)

    def close(self):
        with self._lock:
            self._stop = True
            self._lock.notify()
        self._worker.join()
        self._graphs.close()

    # --------------------------------------------------------------- worker
    def _next_batch(self):
        """Wait for a full batch, or for the oldest request's deadline;
        -> (batch, index snapshot, dequeue time), or None once closed and
        drained."""
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
            t_deq = time.monotonic()
            batch = self._queue[: self.batch_size]
            del self._queue[: len(batch)]
            # a hot swap after this point applies to the NEXT batch; a
            # donating ingest must not write into the snapshot's buffers
            self._inflight = len(batch)
            self._serving = self.index if batch else None
            return batch, self.index, t_deq

    def _padded(self, batch) -> np.ndarray:
        qs = np.stack([it[0] for it in batch])
        pad = self.batch_size - qs.shape[0]
        if pad:
            qs = np.concatenate([qs, np.zeros((pad, qs.shape[1]), qs.dtype)])
        return qs

    def _search(self, index, qs, profile=None, sink=None, graph=False):
        """The batch's search and its answers' copies; with a timeline
        ``sink`` the index's phases record under it, and ``sink.t_copy``
        takes the clock just before the copies.  ``graph``: the batch may
        be answered by a CUDA graph's replay (no request asked for a
        profile)."""
        kwargs = {"merge": self.merge} if self.merge else {}
        if self.max_postings is not None:
            kwargs["max_postings"] = self.max_postings
        if profile is not None:
            kwargs["profile"] = profile
        graph = graph and self._graphs.engages(index, self.engine)
        with annotation("repro.engine.dispatch",
                        self.tracer is not None and self.tracer.annotate):
            # the dtype itself, not its str(): numpy builds that string in
            # Python on every call, and the watch stringifies a signature
            # only when it records a build
            with self.compile_watch.region(
                    "engine.dispatch",
                    sig=(qs.shape, qs.dtype, self.engine, self.k,
                         self.page, self.merge or "gather")):
                # the index puts the batch on its own device
                rows = page_rows()
                with sink or _NO_SINK, WalkTally() as walk:
                    ids, scores = self._graphs.search(
                        index, qs, lambda q: index.search(
                            q, k=self.k, page=self.page, trim=self.trim,
                            engine=self.engine, **kwargs), graph)
                if walk.rounds:
                    self._c_walk_entries.inc(walk.entries)
                    self._c_walk_tokens.inc(walk.tokens)
                    self._c_walk_rounds.inc(walk.rounds)
                rows = page_rows() - rows
                if rows:
                    self._c_page_rows.inc(rows)
                if sink is not None:
                    sink.t_copy = time.monotonic()
                # the answers' two copies to the host: the batch's only
                # synchronisation
                ids = torch.as_tensor(ids).cpu()  # host-seam: answer
                scores = torch.as_tensor(scores).cpu()  # host-seam: answer
                return np.asarray(ids), np.asarray(scores)

    def _run(self):
        tl = self.metrics.timeline
        t_top = None        # the loop's top, read while the timeline records
        while True:
            got = self._next_batch()
            if got is None:
                return
            batch, index, t_deq = got
            if not batch:
                continue
            bid = tl.new_batch()
            sink = tl.sink(bid, self.group) if tl.recording() else None
            # one t_deq for the whole batch: every wait below is
            # (t_deq - enqueue), the same clock read
            self._h_wait.observe_many([t_deq - it[2] for it in batch])
            self._h_occupancy.observe(len(batch) / self.batch_size)
            try:
                error = prof = None
                t_dispatch = t_deq        # overwritten once the batch is built
                # a failing search fails only this batch's futures
                try:
                    qs = self._padded(batch)
                    if any(it[4] for it in batch):
                        # ONE dispatch node shared by every profiled
                        # request of the batch; the index annotates its
                        # phases into it when it takes a profile
                        prof = ProfileNode(
                            "dispatch", batch_size=len(batch),
                            engine=self.engine, k=self.k, page=self.page,
                            **self._metric_labels)
                    t_dispatch = time.monotonic()
                    ids, scores = self._search(
                        index, qs, prof if prof is not None
                        and _accepts_profile(index) else None, sink,
                        graph=prof is None)
                except Exception as exc:  # noqa: BLE001 - fwd to futures
                    t_done = time.monotonic()
                    error = exc
                else:
                    t_done = time.monotonic()
                    if prof is not None:
                        prof.duration_s = t_done - t_dispatch
                self._h_dispatch.observe(t_done - t_dispatch)
                # spans before futures: resolving one finishes its trace,
                # and the slow log serializes the spans at finish
                for _, _, t_enq, tr, _ in batch:
                    if not tr:
                        continue
                    tr.span("queue_wait", t0=t_enq, t1=t_deq,
                            group=self.group, batch=bid)
                    tr.span("batch_form", t0=t_deq, t1=t_dispatch,
                            batch_size=len(batch), group=self.group,
                            batch=bid)
                    tr.span("dispatch", t0=t_dispatch, t1=t_done,
                            group=self.group, batch_size=len(batch),
                            batch=bid,
                            **({} if error is None
                               else {"error": repr(error)}))
                if error is not None:
                    for _, fut, _, _, _ in batch:
                        if not fut.done():
                            fut.set_exception(error)
                    self._c_failed.inc(len(batch))
                    continue
                for i, (_, fut, t_enq, _, want) in enumerate(batch):
                    if fut.done():          # caller may have cancelled
                        continue
                    if want:
                        # shared clock reads: queue_wait + batch_form +
                        # dispatch tile the root
                        root = ProfileNode(
                            "query", t_done - t_enq, engine=self.engine,
                            k=self.k, page=self.page, **self._metric_labels)
                        root.child("queue_wait", t_deq - t_enq)
                        root.child("batch_form", t_dispatch - t_deq,
                                   batch_size=len(batch))
                        root.children.append(prof)
                        fut.set_result((ids[i], scores[i], root.to_dict()))
                    else:
                        fut.set_result((ids[i], scores[i]))
                self._c_completed.inc(len(batch))
                self._c_kernel_path.inc()       # one dispatch on `engine`
            finally:
                with self._lock:
                    self._inflight = 0
                    self._serving = None
                if sink is None:
                    t_top = None
                else:
                    t_end = time.monotonic()
                    tl.record_batch(sink, t_top, t_deq, t_dispatch, t_done,
                                    t_end)
                    t_top = t_end
