"""ClusterEngine: per-replica-group request batchers + failover routing.

The coordinating-node control plane over the sharded data plane.  A
``(data, replica)`` mesh gives R bit-identical serving copies of the
doc-sharded corpus, but one
:class:`~repro_torch.serve.engine.BatchedSearchEngine` fronting the whole
mesh only materialises that parallelism *inside a single batch* (queries
round-robin across groups within one search).
:class:`ClusterEngine` instead views each replica column as an
independent one-group index (:meth:`ShardedVectorIndex.replica_group`)
and runs R independent batchers, one per group.  Where the groups sit on
disjoint devices, that is R concurrent search programs and concurrent QPS
scales with R.  On one card (every cell of a
:class:`~repro_torch.launch.mesh.ShardMesh` is one device) the groups
share every tensor until a write gives a group its own copy of what the
write rebuilds, and every batcher thread launches on the thread's current
stream -- the default stream -- so the groups' kernels serialise on the
card: two batchers overlap one group's host work with the other's device
work, and answers stay bit-identical.

Routing (the ES coordinating node's copy selection):

* **stream affinity** -- a request stream (a user id, a connection)
  pins to one group on first sight, like ES ``preference=<custom_string>``
  user stickiness: the stream's queries batch together and hit one
  group's caches.
* **least-loaded spill** -- when the pinned group's ``pending`` depth
  exceeds ``spill_factor * batch_size``, overflow routes to the
  least-loaded healthy group (adaptive replica selection).  The pin is
  not rewritten: the stream returns home once the spike drains.
* **failover** -- a search failure marks the group down in the
  :class:`~repro_torch.cluster.health.HealthMap` and transparently
  resubmits the affected requests to surviving copies (ES retries a
  failed fetch on the next shard copy).  Results are bit-identical to the
  healthy cluster, because every group computes bit-identical results.
  Only when no healthy copy remains does the caller see the failure.

``inject_failure(group)`` is the failure-injection hook: it poisons that
group's index behind its batcher (every search raises), which exercises
the full detect -> mark_down -> resubmit path end to end without touching
the device.  ``heal`` + ``mark_up`` bring the group back.  With a
``tracer`` that annotates, each group's searches run inside a
``torch.profiler.record_function`` range named ``repro.cluster.group<g>``,
so a trace of concurrent batchers attributes the device time of every
kernel to the group that launched it.

Control-plane writes (``add_documents`` / ``delete``) apply to EVERY
group, down or not -- a downed copy must stay consistent for ``mark_up``,
exactly like ES replica recovery replaying the translog.  Deterministic
ingest routing guarantees every copy assigns identical gids.

``auto_compact=<threshold>`` starts a
:class:`~repro_torch.cluster.maintenance.MaintenanceDaemon` that watches
every group's tombstone ratio and compacts in the background (hot CAS swap, no
dropped queries).

**Durability** (``store=``, :class:`repro_torch.store.durable.Store`):
group 0 is the *primary* -- its index wraps in a write-through
:class:`~repro_torch.store.durable.DurableIndex`, so every cluster
``add_documents``/``delete`` hits the translog (group 0, first in the
fan-out, applies and logs before any replica group applies and before
the cluster acks), the ES primary-owns-the-translog arrangement; replica
groups apply without re-logging because every copy computes the
identical state.  :meth:`restore_group` is then the recovery story: a
replica group whose memory is gone is rebuilt from commit point +
translog replay onto its own mesh column and re-admitted -- instead of
staying down forever or leeching a sibling copy's memory.  Control-plane
writes and restores serialize on one lock so a restore can never miss a
racing ingest.  ``probe_s=<seconds>`` runs
the background canary prober (see
:meth:`~repro_torch.cluster.maintenance.MaintenanceDaemon.probe_once`) so
healed groups re-admit without a manual ``mark_up``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from concurrent.futures import CancelledError, Future
from typing import List, Optional

import numpy as np

from repro_torch.core import TrimFilter
from repro_torch.obs.compile_watch import active_watch
from repro_torch.obs.metrics import default_registry
from repro_torch.obs.profile import ProfileNode
from repro_torch.obs.slowlog import start_request_trace
from repro_torch.obs.tracing import NULL_TRACE, annotation
from repro_torch.serve.engine import BatchedSearchEngine
from repro_torch.store.durable import DurableIndex

from .health import HealthMap
from .maintenance import MaintenanceDaemon

__all__ = ["ClusterEngine"]


class _FailpointIndex:
    """Failure-injection wrapper around one group's index.

    Transparent for every read (attribute access proxies through) but
    ``search`` raises while ``fail`` is set -- the hook ClusterEngine's
    failover path is exercised with.  The fail state lives in a CELL
    shared by every descendant wrapper: mutators (ingest/delete/compact)
    re-wrap their result around the same cell, so the failpoint the
    router holds keeps controlling the group through any number of hot
    swaps (a poisoned group that ingests stays poisoned until ``heal``).
    The cell's ``range`` names the profiler range ``search`` runs in
    (None: no range).

    The mutators take no ``donate`` argument, so a batcher never donates
    a group's buffers: the groups of one index share them.
    """

    def __init__(self, inner, cell: Optional[dict] = None):
        self._cell = (cell if cell is not None
                      else {"fail": None, "range": None})
        self.inner = inner

    @property
    def fail(self) -> Optional[Exception]:
        return self._cell["fail"]

    @fail.setter
    def fail(self, exc: Optional[Exception]) -> None:
        self._cell["fail"] = exc

    def search(self, *args, **kwargs):
        with self.replay_guard():
            return self.inner.search(*args, **kwargs)

    def replay_guard(self):
        """What ``search`` does around the inner search, which a batcher
        also enters around each replay of a captured search
        (:mod:`repro_torch.serve.graphs`): raise the planted failure, or
        open the profiler range."""
        if self.fail is not None:
            raise self.fail
        name = self._cell["range"]
        return annotation(name, name is not None)

    def add_documents(self, vectors):
        return _FailpointIndex(self.inner.add_documents(vectors), self._cell)

    def delete(self, ids):
        return _FailpointIndex(self.inner.delete(ids), self._cell)

    def compact(self):
        return _FailpointIndex(self.inner.compact(), self._cell)

    def merge_segments(self, start: int = 0, count=None):
        return _FailpointIndex(self.inner.merge_segments(start, count),
                               self._cell)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class _Request:
    """One routed query: its future, the groups it tried and the ones it
    marked down, its trace.  ``attempt`` routes it to a batcher and
    ``finish`` is that batcher's completion callback, which fails over by
    attempting again.  The state lives on this object rather than in two
    closures that name each other, so a request that succeeds leaves no
    reference cycle: a closed cluster frees its groups' tensors once its
    last request resolves, without waiting for the cyclic collector.  A
    failed search's traceback still ties the batcher's frames to its
    futures until the collector runs, as any stored exception does."""

    def __init__(self, cluster: "ClusterEngine", q: np.ndarray, stream,
                 trace, outer: Future):
        self.cluster, self.q, self.stream = cluster, q, stream
        self.trace, self.outer = trace, outer
        self.tried: set = set()
        self.marked: list = []            # groups THIS request marked down

    def _fail(self, err) -> None:
        self.cluster._c_failed.inc()
        self.trace.finish(error=repr(err))
        if not self.outer.done():
            self.outer.set_exception(err)

    def attempt(self, prev_exc=None) -> None:
        cl, trace = self.cluster, self.trace
        try:
            g = cl._pick(self.stream, exclude=self.tried, trace=trace)
        except RuntimeError as exc:
            if prev_exc is not None:
                # every copy failed the SAME request: the request, not
                # the cluster, is the likely fault (a genuinely dead
                # copy fails while its siblings answer) -- undo this
                # request's mark_downs so one poisoned query cannot
                # black-hole the whole cluster, and surface the error.
                # readmit, not mark_up: an operator drain recorded
                # while this request was in flight must survive
                for m in self.marked:
                    cl.health.readmit(m)
                    trace.event("rollback_readmit", group=m)
            self._fail(prev_exc or exc)
            return
        self.tried.add(g)
        try:
            inner = cl._batchers[g].submit(self.q, trace=trace)
        except RuntimeError as exc:       # batcher closed under us
            self._fail(prev_exc or exc)
            return
        if prev_exc is not None:          # this attempt IS the resubmit
            cl._c_resubmits.inc()
            trace.event("failover_resubmit", group=g, error=repr(prev_exc))
        inner.add_done_callback(lambda f: self.finish(f, g))

    def finish(self, inner: Future, g: int) -> None:
        cl, trace, outer = self.cluster, self.trace, self.outer
        if outer.cancelled():
            trace.finish(error="cancelled")
            return
        try:
            exc = inner.exception()
        except CancelledError as cancel:
            exc = cancel
        if exc is None:
            cl._c_completed.inc()
            cl._c_group_completed[g].inc()
            trace.finish()
            if not outer.done():
                outer.set_result(inner.result())
            return
        # failover: this copy is bad -- take it out of routing and replay
        # the request on the next healthy copy
        if cl.health.mark_down(g):
            self.marked.append(g)
            trace.event("group_down", group=g)
        self.attempt(prev_exc=exc)


class ClusterEngine:
    def __init__(
        self,
        index,                            # ShardedVectorIndex | list of them
        batch_size: int = 32,
        max_wait_s: float = 0.005,
        k: int = 10,
        page: int = 320,
        trim: Optional[TrimFilter] = TrimFilter(0.05),
        engine: str = "codes",
        merge: Optional[str] = None,
        max_postings: "Optional[int | str]" = None,
        spill_factor: float = 2.0,
        max_stream_pins: int = 4096,
        auto_compact: Optional[float] = None,
        compact_interval_s: float = 0.05,
        store=None,
        probe_s: Optional[float] = None,
        metrics=None,
        tracer=None,
        slowlog=None,
        compile_watch=None,
    ):
        """``index`` is a ShardedVectorIndex (its R replica groups become
        the cluster's groups) or an explicit list of group indexes (full
        serving copies, flat or sharded).  ``auto_compact`` is a
        tombstone-ratio threshold; set, it starts the background
        maintenance daemon.  ``store`` attaches a durability directory
        (group 0 becomes the write-through primary, a baseline commit is
        written if none exists, and
        :meth:`restore_group` re-admits downed groups from disk).
        ``probe_s`` runs the background canary prober at that interval so
        healed groups re-admit automatically.  ``metrics``/``tracer``
        inject the observability plane (:mod:`repro_torch.obs`): the
        registry is shared with every per-group batcher (series labelled
        ``group=g``) and the health map; the tracer samples per-request
        span traces that follow a query through routing, queue wait,
        and dispatch, with spill / failover-resubmit events attached, and
        when it annotates, names each group's profiler range."""
        if isinstance(index, (list, tuple)):
            groups = list(index)
        else:
            groups = [index.replica_group(g)
                      for g in range(index.n_replicas)]
        if not groups:
            raise ValueError("need at least one replica group")
        self.metrics = metrics if metrics is not None else default_registry()
        self.tracer = tracer
        # request-level tail capture lives at the CLUSTER seam (one
        # skeleton per request, spanning routing + failover resubmits);
        # per-group batchers receive traces from here, never admit their
        # own (repro_torch.obs.slowlog)
        self.slowlog = slowlog
        self.compile_watch = (compile_watch if compile_watch is not None
                              else active_watch())
        self.store = store
        if store is not None:
            # an explicitly injected store registry wins; a store on the
            # process default joins the cluster's registry so one
            # stats() rollup sees everything -- joined BEFORE open_index,
            # whose baseline commit must land in the cluster's counters
            if store.metrics is default_registry():
                store.metrics = self.metrics
            if not isinstance(groups[0], DurableIndex):
                groups[0] = store.open_index(groups[0])
        annotate = tracer is not None and tracer.annotate
        self._failpoints = [
            _FailpointIndex(idx, {"fail": None, "range": (
                f"repro.cluster.group{g}" if annotate else None)})
            for g, idx in enumerate(groups)]
        self.health = HealthMap(len(groups), metrics=self.metrics)
        self._batchers: List[BatchedSearchEngine] = [
            BatchedSearchEngine(
                fp, batch_size=batch_size, max_wait_s=max_wait_s, k=k,
                page=page, trim=trim, engine=engine, merge=merge,
                max_postings=max_postings, metrics=self.metrics, group=g,
                compile_watch=self.compile_watch)
            for g, fp in enumerate(self._failpoints)
        ]
        self._c_submitted = self.metrics.counter("cluster.requests.submitted")
        self._c_completed = self.metrics.counter("cluster.requests.completed")
        self._c_failed = self.metrics.counter("cluster.requests.failed")
        self._c_spills = self.metrics.counter("cluster.routing.spills")
        self._c_resubmits = self.metrics.counter("cluster.failover.resubmits")
        self._c_group_completed = [
            self.metrics.counter("cluster.requests.group_completed", group=g)
            for g in range(len(groups))]
        self.spill_threshold = max(1, int(  # host-seam: host arithmetic
            spill_factor * batch_size))
        # LRU-capped pin map: stream ids are caller-supplied (users,
        # connections), so an uncapped map is an unbounded leak in a
        # long-lived service.  Evicting a cold pin is benign -- every
        # group returns bit-identical results, the stream just re-pins.
        self.max_stream_pins = max(1, max_stream_pins)
        self._streams: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        # serializes control-plane writes (ingest/delete) against
        # restore_group's recover-then-swap, so a restore can never miss
        # an op that landed between its disk read and its swap
        self._ctl_lock = threading.Lock()
        # restores in flight, for _cluster/health (guarded by _lock, not
        # _ctl_lock: health polls must not block behind a running restore)
        self._restores_inflight = 0
        self._closed = False
        self.maintenance: Optional[MaintenanceDaemon] = None
        if auto_compact is not None or probe_s is not None:
            # compaction sweeps and canary probes keep independent
            # cadences (the daemon thread ticks at the faster of the two)
            self.maintenance = MaintenanceDaemon(
                self._batchers,
                threshold=(auto_compact if auto_compact is not None
                           else float("inf")),
                interval_s=(compact_interval_s if auto_compact is not None
                            else probe_s),
                probe_interval_s=probe_s,
                health=self.health, store=store,
                probe=probe_s is not None,
                # probe-only daemons (auto_compact=None) must not start
                # background merges either -- maintenance work is opt-in
                merge_policy=("auto" if auto_compact is not None else None),
                metrics=self.metrics).start()

    # ------------------------------------------------------------ topology
    @property
    def n_groups(self) -> int:
        return len(self._batchers)

    @property
    def batchers(self):
        """The per-group batchers (read-only view; load/ingest state)."""
        return tuple(self._batchers)

    def group_index(self, group: int):
        """The index currently served by ``group`` (unwrapped)."""
        return self._batchers[group].index.inner

    def loads(self):
        """(pending per group) -- the router's own routing signal."""
        return tuple(b.pending for b in self._batchers)

    def stats(self) -> dict:
        """ES ``_cluster/stats`` + ``_cat/shards``-style rollup: per-group
        batcher stats + health state, routing counters (spills, failover
        resubmits, per-group completions -- their sum reconciles exactly
        with queries issued), health-transition counters, and the
        maintenance/store sections when wired (see
        :func:`repro_torch.obs.stats.cluster_stats`)."""
        from repro_torch.obs.stats import cluster_stats

        return cluster_stats(self)

    def cluster_health(self) -> dict:
        """ES ``GET _cluster/health``: green/yellow/red from the
        HealthMap plus queue depths, in-flight restores, pending
        maintenance plans, and the transition ledger (see
        :func:`repro_torch.obs.stats.cluster_health`)."""
        from repro_torch.obs.stats import cluster_health

        return cluster_health(self)

    def node_stats(self) -> dict:
        """ES ``GET _nodes/stats``: per-device index residency across
        every replica group (see :func:`repro_torch.obs.stats.node_stats`)."""
        from repro_torch.obs.stats import node_stats

        return node_stats(self)

    # ------------------------------------------------------------- routing
    def _pick(self, stream, exclude=(), trace=NULL_TRACE) -> int:
        """The group a request goes to (pin, spill or least loaded); a
        ``router.pick`` span on the calling thread while the timeline
        records."""
        tl = self.metrics.timeline
        t0 = time.monotonic_ns() if tl.recording() else None
        try:
            up = [g for g in self.health.up_groups() if g not in exclude]
            if not up:
                raise RuntimeError("no healthy replica group available")
            least = min(up, key=lambda g: self._batchers[g].pending)
            if stream is None:
                return least
            with self._lock:
                pinned = self._streams.get(stream)
                if pinned is None:
                    self._streams[stream] = pinned = least
                self._streams.move_to_end(stream)
                while len(self._streams) > self.max_stream_pins:
                    self._streams.popitem(last=False)
            if (pinned in up and self._batchers[pinned].pending
                    <= self.spill_threshold):
                return pinned
            if pinned in up and least != pinned:
                # the pinned group is healthy but over the spill
                # threshold: this request overflows to the least-loaded
                # copy (adaptive replica selection) -- a routing event
                # worth metering
                self._c_spills.inc()
                trace.event("spill", from_group=pinned, to_group=least)
            return least                  # spill; the pin itself persists
        finally:
            if t0 is not None:
                tl.record("router.pick", t0, time.monotonic_ns())

    def submit(self, query_vec: np.ndarray, stream=None) -> Future:
        """Route one query -> Future of (ids, scores).

        The returned future resolves even through a group failure: the
        completion callback marks the failed group down and resubmits to
        the next healthy copy (each copy tried at most once).  Only with
        no healthy copy left does the future carry the failure."""
        if self._closed:
            raise RuntimeError("engine closed")
        outer: Future = Future()
        trace = start_request_trace(self.tracer, self.slowlog, "query",
                                    stream=stream)
        self._c_submitted.inc()
        _Request(self, np.asarray(query_vec, np.float32), stream, trace,
                 outer).attempt()
        return outer

    def search(self, query_vec: np.ndarray, stream=None,
               timeout: float = 10.0):
        return self.submit(query_vec, stream=stream).result(timeout=timeout)

    def profile(self, query_vec: np.ndarray, stream=None,
                timeout: float = 10.0):
        """ES ``_search?profile=true``: one query -> ``(ids, scores,
        profile_dict)`` where the tree adds the cluster's routing phase
        (group picked, healthy-copy count) on top of the chosen group's
        engine profile (queue wait -> batch form -> dispatch -> the
        index's phase children).  Scores are bit-identical to
        :meth:`search` -- profiling only fences phase boundaries.

        The profile path routes once and does NOT fail over (a profile
        of a failed dispatch would profile the wrong thing); the error
        propagates so the caller can fall back to :meth:`search`.
        """
        if self._closed:
            raise RuntimeError("engine closed")
        q = np.asarray(query_vec, np.float32)
        t0 = time.monotonic()
        root = ProfileNode("cluster.query", n_groups=self.n_groups,
                           **({} if stream is None else {"stream": stream}))
        up = len(self.health.up_groups())
        g = self._pick(stream)
        t_route = time.monotonic()
        self._c_submitted.inc()
        root.child("route", t_route - t0, group=g, up_groups=up)
        try:
            ids, scores, prof = self._batchers[g].submit(
                q, profile=True).result(timeout=timeout)
        except Exception:
            self._c_failed.inc()
            raise
        self._c_completed.inc()
        self._c_group_completed[g].inc()
        root.children.append(prof)
        root.duration_s = time.monotonic() - t0
        return ids, scores, root.to_dict()

    # ------------------------------------------------------- control plane
    def add_documents(self, vectors) -> int:
        """Hot-add documents to EVERY replica group (down groups included:
        a copy must stay consistent to be markable up again).  Returns the
        first assigned global id -- identical in every group because
        ingest routing is deterministic.  With a store attached, group 0
        (first in the fan-out) write-throughs the translog, so the op is
        durable before any group acks."""
        with self._ctl_lock:
            firsts = {b.add_documents(vectors) for b in self._batchers}
        if len(firsts) != 1:              # pragma: no cover - invariant
            raise RuntimeError(f"replica groups diverged: first ids {firsts}")
        return firsts.pop()

    def delete(self, ids) -> None:
        """Hot-tombstone documents in every replica group."""
        with self._ctl_lock:
            for b in self._batchers:
                b.delete(ids)

    def restore_group(self, group: int, mesh=None) -> int:
        """Re-admit replica group ``group`` from DISK: crash-recover the
        index (latest commit point + translog replay) onto the group's
        own mesh column (``mesh``, by default the one it is served on),
        swap it behind the group's batcher, clear any injected fault, and
        mark the group up.  Returns the recovered translog seqno.

        A group whose in-memory copy is lost (not merely unrouted) comes
        back from durable state instead of staying down.  Runs under the
        control-plane write lock, so every op acked before the restore is
        in the recovered state and every op after it applies to the
        swapped index -- the restored copy is bit-identical to its
        surviving siblings (pinned by tests/test_torch_cluster.py at 4
        shards x 2 groups).  The restored group owns new tensors: on one
        card that is a whole index's bytes beside its siblings'."""
        if self.store is None:
            raise RuntimeError(
                "no store attached; construct ClusterEngine(store=...)")
        if not 0 <= group < self.n_groups:
            raise ValueError(
                f"group must be in [0, {self.n_groups}), got {group}")
        with self._lock:
            self._restores_inflight += 1
        try:
            with self._ctl_lock:
                if mesh is None:
                    mesh = self._batchers[group].index.mesh
                # by keyword: the store's first positional is a device
                index, seq = self.store.recover_index(mesh=mesh)
                if group == 0:            # the primary keeps write-through
                    index = DurableIndex(index, self.store, seq=seq)
                fp = _FailpointIndex(index, self._failpoints[group]._cell)
                fp.fail = None            # restoring clears the fault
                self._failpoints[group] = fp
                self._batchers[group].swap_index(fp)
        finally:
            with self._lock:
                self._restores_inflight -= 1
        self.health.mark_up(group)
        self.metrics.counter("cluster.restores", group=group).inc()
        return seq

    @property
    def restores_in_flight(self) -> int:
        """Disk restores currently running (ES recoveries in flight --
        a ``_cluster/health`` field)."""
        with self._lock:
            return self._restores_inflight

    # ------------------------------------------------------------- health
    def mark_down(self, group: int) -> bool:
        """Operator/drain hook: stop routing NEW work to ``group``.
        Requests already queued on its batcher drain normally.  Recorded
        as a DRAIN (operator intent), so the background canary prober
        will not re-admit the group behind the operator's back -- only
        :meth:`mark_up` (or :meth:`restore_group`) brings it back.  The
        failover path marks downs through ``health.mark_down`` directly
        (a fault, probe-eligible)."""
        return self.health.mark_down(group, drain=True)

    def mark_up(self, group: int) -> bool:
        return self.health.mark_up(group)

    def inject_failure(self, group: int, exc: Optional[Exception] = None):
        """Failure injection: every search on ``group`` raises until
        :meth:`heal`.  The routing layer discovers it the honest way -- a
        failed request -- and fails over."""
        self._failpoints[group].fail = exc if exc is not None else (
            RuntimeError(f"injected failure: replica group {group} is down"))

    def heal(self, group: int) -> None:
        """Clear an injected failure (does not flip health: pair with
        :meth:`mark_up`, the way an ES node rejoin is a separate event
        from the fault clearing)."""
        self._failpoints[group].fail = None

    # ----------------------------------------------------------- lifecycle
    def close(self):
        self._closed = True
        if self.maintenance is not None:
            self.maintenance.stop()
        for b in self._batchers:
            b.close()
