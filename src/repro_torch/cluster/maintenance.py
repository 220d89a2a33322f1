"""Background tiered-merge + auto-compaction daemon (the Lucene merge
scheduler).

Elasticsearch never asks the operator to reclaim deleted docs or fold
segments: a background merge policy (Lucene ``TieredMergePolicy``) picks a
few similar-sized segments per pass, merges them off the query path, and
keeps the per-index segment count bounded while deletes are reclaimed
incrementally.  :class:`MaintenanceDaemon` is that loop for the serving
tier, and :class:`TieredMergePolicy` is its planner:

1. **Delete-pressure rewrite** -- any sealed segment whose per-segment
   ``deleted_ratio`` exceeds ``segment_deletes`` (ES
   ``deletes_pct_allowed``) is rewritten alone, reclaiming its tombstones
   without touching its neighbours.  This is what fixes the whole-index
   vs per-shard accounting drift: the daemon used to threshold only on
   the global ``tombstone_ratio``, which cannot see *which generation*
   the deletes hit.
2. **Tiered fold** -- a contiguous run of ``merge_factor`` similar-sized
   segments (max <= merge_factor * min rows, Lucene's tier criterion)
   merges into one, so N ingest-sealed generations fold into
   O(log_mf N) tiers instead of accumulating.
3. **Full compact, demoted** -- only when neither applies and the global
   ``tombstone_ratio`` (worst per-shard dead fraction -- now dominated by
   BASE deletes, since segment deletes are reclaimed by 1) still exceeds
   ``threshold`` does the old all-or-nothing ``compact()`` run: the final
   fold of the last tier.

Merge passes run CONCURRENTLY across replica groups (they are
independent copies; each pass builds new tensors for its own group and
installs them through its own CAS, never writing a tensor the groups
share), on short-lived worker threads only when more than one group has
work -- an idle tick spawns nothing.  On one card the groups' rebuilds
share its memory and its default stream: two full compacts at once need
two new bases beside the shared one.  Every applied pass
hot-swaps via :meth:`BatchedSearchEngine.swap_index`.

The swap discipline is what makes this safe under live traffic:

* the expensive rebuild runs OUTSIDE the engine lock, against a snapshot
  of the served index;
* the swap is a compare-and-swap on that snapshot -- if an ingest or
  delete landed meanwhile (``self.index`` moved), the stale rebuild is
  dropped, counted in ``maintenance.merges.discarded`` (or
  ``maintenance.compactions.discarded``), and the next tick retries
  against fresh state;
* in-flight batches finish on the index they dequeued with; no query is
  ever dropped or served a half-built index.

Compaction preserves global ids and exact df (the delete path already
keeps df exact), so results are unchanged across a background compact
apart from tombstone-free posting lists.

Down groups (per the cluster :class:`~repro_torch.cluster.health.HealthMap`)
are skipped -- a dead copy is failover's problem, not maintenance's.  A
rebuild that ITSELF fails (device OOM, compile error) is recorded in
``failures`` and its snapshot quarantined, so the daemon neither dies nor
hot-loops the same expensive failure; the next ingest/delete produces a
new snapshot and re-arms the group.

**Durability** (``store=``, :class:`repro_torch.store.durable.Store`): after a
successful compact-and-swap of an index that carries ``translog_seq``
(the :class:`~repro_torch.store.durable.DurableIndex` commit metadata riding
through the CAS), the daemon rolls a new commit point and trims the
replayed translog -- the ES flush that follows a merge.  The committed
(state, seq) pair is exactly the pair that won the CAS, so a racing
ingest can never be committed out from under its translog record.  A
failing commit (disk error) is recorded in ``failures``, never fatal.

**Health probing** (``probe=True``, needs ``health``): each background
tick also sends a canary query through every FAULTED group's batcher and
``mark_up``s the ones that answer -- the ES master re-promoting a shard
copy once it responds again, so re-admission after :meth:`ClusterEngine.
heal` (or a transient fault clearing) no longer requires a manual
``mark_up`` or a poisoned-request rollback.  Operator-DRAINED groups
(``mark_down(g, drain=True)``, the ClusterEngine operator hook) are
exempt: a drain is intent, not a fault, and the prober must not undo it
behind the operator's back.  A canary that fails leaves the group down
and is not recorded as a failure (down is its steady state).
``probe_once()`` is the deterministic entry point.

``poll_once()`` exposes one deterministic compaction sweep for tests;
``start()`` runs poll + probe on a daemon thread every ``interval_s``.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.obs.compile_watch import watch_region
from repro_torch.obs.metrics import default_registry
from repro_torch.obs.tracing import MERGE_KINDS, MERGE_OUTCOMES, to_ns

__all__ = ["MaintenanceDaemon", "TieredMergePolicy"]


class TieredMergePolicy:
    """Lucene-``TieredMergePolicy``-style merge planner.

    ``select(index)`` inspects the index's sealed :class:`Segment`
    generations and returns one merge plan (a dict with ``start``/
    ``count``/``reason``) or ``None``.  Selection order: a segment past
    the per-segment ``segment_deletes`` ratio is rewritten alone
    (``count=1`` -- Lucene's singleton merge that exists purely to reclaim
    deletes); otherwise the first contiguous run of ``merge_factor``
    similar-sized segments (largest <= merge_factor * smallest, by rows)
    folds into one.  Indexes without segments (flat, or plain
    ``VectorIndex``) always yield ``None`` -- the daemon then falls back
    to the global compact threshold.
    """

    def __init__(self, merge_factor: int = 4, segment_deletes: float = 0.2):
        if merge_factor < 2:
            raise ValueError(f"merge_factor must be >= 2, got {merge_factor}")
        if not 0.0 < segment_deletes:
            raise ValueError(
                f"segment_deletes must be positive, got {segment_deletes}")
        self.merge_factor = merge_factor
        self.segment_deletes = segment_deletes

    def select(self, index) -> Optional[dict]:
        segs = getattr(index, "segments", ())
        if not segs:
            return None
        for i, s in enumerate(segs):
            if s.deleted_ratio > self.segment_deletes:
                return {"start": i, "count": 1, "reason": "deletes",
                        "deleted_ratio": s.deleted_ratio}
        mf = self.merge_factor
        if len(segs) >= mf:
            for i in range(len(segs) - mf + 1):
                rows = [max(s.n_rows, 1) for s in segs[i:i + mf]]
                if max(rows) <= mf * min(rows):
                    return {"start": i, "count": mf, "reason": "tier"}
        return None


class MaintenanceDaemon:
    def __init__(
        self,
        batchers: Sequence,               # BatchedSearchEngine per group
        threshold: float = 0.2,
        interval_s: float = 0.05,
        health=None,                      # Optional[HealthMap]
        store=None,                       # Optional[repro_torch.store.Store]
        probe: bool = False,
        probe_timeout_s: float = 5.0,
        probe_interval_s: Optional[float] = None,
        metrics=None,
        merge_policy="auto",              # "auto" | None | TieredMergePolicy
    ):
        if not 0.0 < threshold:
            raise ValueError(f"threshold must be positive, got {threshold}")
        if probe and health is None:
            raise ValueError("probe=True needs a HealthMap to mark_up into")
        self._batchers = list(batchers)
        # compaction/commit wall times feed the stats layer (the ES merge
        # stats); timestamps are host-side around the rebuild dispatch
        self.metrics = metrics if metrics is not None else default_registry()
        self.threshold = threshold
        self.interval_s = interval_s
        self._health = health
        self._store = store
        self.probe = probe
        self.probe_timeout_s = probe_timeout_s
        # probing runs on its own cadence (default: every compaction tick);
        # the two loops share the thread but not the clock, so a fast
        # compaction interval does not turn into a canary storm and vice
        # versa
        self.probe_interval_s = (interval_s if probe_interval_s is None
                                 else probe_interval_s)
        self._probes: dict = {}           # group -> in-flight canary Future
        self.merge_policy = (TieredMergePolicy() if merge_policy == "auto"
                             else merge_policy)
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.events: List[dict] = []      # one entry per applied compaction
        self.merge_events: List[dict] = []  # one entry per applied merge
        self.failures: List[dict] = []    # one entry per failed rebuild
        self.probe_events: List[dict] = []  # one entry per re-admission
        self.commits: int = 0             # commit points rolled post-pass
        self._quarantine: dict = {}       # group -> snapshot whose rebuild
        #                                   failed; skipped until it changes

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MaintenanceDaemon":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @property
    def compactions(self) -> int:
        return len(self.events)

    @property
    def merges(self) -> int:
        return len(self.merge_events)

    # ----------------------------------------------------------------- work
    def poll_once(self) -> int:
        """One maintenance sweep over every group; returns passes applied
        (merges + compactions).  Deterministic entry point for tests and
        operators.

        Plan/apply split: a cheap host-side planning pass first decides
        per group whether a merge (the policy's pick) or a full compact
        (global tombstone pressure, the demoted last resort) is due; only
        groups WITH work get an apply pass, and when several have work the
        passes run concurrently -- replica groups are independent copies,
        each apply builds only its own group's tensors, its own CAS, and
        the thread-safe store/metrics."""
        plans = self._plan()
        if not plans:
            return 0
        if len(plans) == 1:
            return self._apply(*plans[0])
        with ThreadPoolExecutor(max_workers=len(plans)) as ex:
            return sum(ex.map(lambda p: self._apply(*p), plans))

    def _plan(self) -> List[tuple]:
        """The host-side planning pass: ``(group, batcher, snapshot,
        plan)`` per group with work due.  Pure inspection -- no rebuild,
        no lock, no state change -- so it doubles as the
        ``_cluster/health`` pending-maintenance probe."""
        plans = []
        for g, batcher in enumerate(self._batchers):
            if self._health is not None and not self._health.is_up(g):
                continue
            snapshot = batcher.index
            if self._quarantine.get(g) is snapshot:
                continue    # this exact state already failed to rebuild --
                #             don't hot-loop the failure; any ingest/delete
                #             produces a new snapshot and re-arms the group
            plan = None
            if self.merge_policy is not None:
                sel = self.merge_policy.select(snapshot)
                if sel is not None:
                    plan = {"kind": "merge", **sel}
            if plan is None:
                ratio = getattr(snapshot, "tombstone_ratio", 0.0)
                if ratio > self.threshold:
                    plan = {"kind": "compact", "tombstone_ratio": ratio}
            if plan is not None:
                plans.append((g, batcher, snapshot, plan))
        return plans

    def pending_plans(self) -> List[dict]:
        """Maintenance work currently due but not yet applied, one JSON-
        ready dict per group with work (``{"group": g, "kind": "merge" |
        "compact", ...}``) -- the ES ``number_of_pending_tasks`` field of
        ``cluster_health()``.  Planning only; never applies anything."""
        return [{"group": g, **plan} for g, _b, _s, plan in self._plan()]

    def _apply(self, g: int, batcher, snapshot, plan: dict) -> int:
        """Run one planned pass: rebuild outside the engine lock, install
        via CAS, record, commit.  Returns 1 if the pass was applied.  A
        rebuild that an ingest or delete raced is thrown away and counted
        in ``maintenance.merges.discarded`` (a compaction in
        ``maintenance.compactions.discarded``)."""
        kind = plan["kind"]
        t0 = time.monotonic()
        try:
            if kind == "merge":
                with watch_region("maintenance.merge",
                                  sig=(plan["start"], plan["count"])):
                    rebuilt = snapshot.merge_segments(plan["start"],
                                                      plan["count"])
            else:
                with watch_region("maintenance.compact",
                                  sig=(int(getattr(snapshot, "n_ids", 0)),)):
                    rebuilt = snapshot.compact()      # outside the lock
        except Exception as exc:  # noqa: BLE001 - recorded, not fatal
            # a failing on-device rebuild (OOM, compile error) must not
            # kill maintenance for the healthy groups -- log it and
            # quarantine the snapshot instead of silently retrying the
            # same expensive failure every tick
            self._quarantine[g] = snapshot
            entry = {"group": g, "kind": kind, "error": repr(exc)}
            if kind == "compact":
                entry["tombstone_ratio"] = plan["tombstone_ratio"]
            self.failures.append(entry)
            self.metrics.counter("maintenance.failures", group=g).inc()
            self._span(g, kind, t0, time.monotonic(), "failed")
            return 0
        t1 = time.monotonic()
        duration = t1 - t0
        try:
            swapped = batcher.swap_index(rebuilt, expected=snapshot)
        except RuntimeError:
            self._span(g, kind, t0, t1, "discarded")
            return 0                                  # engine closed mid-sweep
        if not swapped:
            # CAS miss: an ingest/delete raced the rebuild -- the next
            # sweep re-evaluates the fresh index
            self.metrics.counter(
                "maintenance.merges.discarded" if kind == "merge"
                else "maintenance.compactions.discarded", group=g).inc()
            self._span(g, kind, t0, t1, "discarded")
            return 0
        self._span(g, kind, t0, t1, "applied")
        self._quarantine.pop(g, None)
        if kind == "merge":
            run = snapshot.segments[plan["start"]:plan["start"]
                                    + plan["count"]]
            reclaimed = sum(s.tombstones for s in run)
            self.merge_events.append({
                "group": g,
                "start": plan["start"],
                "count": plan["count"],
                "reason": plan["reason"],
                "reclaimed": reclaimed,
                "n_segments": len(rebuilt.segments),
                "duration_s": duration,
            })
            self.metrics.counter("maintenance.merges", group=g).inc()
            self.metrics.counter("maintenance.merge.reclaimed",
                                 group=g).inc(reclaimed)
            self.metrics.histogram(
                "maintenance.merge.duration_s").observe(duration)
        else:
            self.events.append({
                "group": g,
                "tombstone_ratio": plan["tombstone_ratio"],
                "n_ids": snapshot.n_ids,
                "duration_s": duration,
            })
            self.metrics.counter("maintenance.compactions", group=g).inc()
            self.metrics.histogram(
                "maintenance.compact.duration_s").observe(duration)
        self._commit(g, rebuilt)
        return 1

    def _span(self, g: int, kind: str, t0: float, t1: float,
              outcome: str) -> None:
        """The rebuild as a ``maintenance.merge`` span, while the
        registry's timeline records."""
        tl = self.metrics.timeline
        if tl.recording():
            tl.record("maintenance.merge", to_ns(t0), to_ns(t1), group=g,
                      arg0=MERGE_OUTCOMES.index(outcome),
                      arg1=MERGE_KINDS.index(kind))

    def _commit(self, g: int, compacted) -> None:
        """Roll a commit point for the state that won the CAS (the ES
        flush after a merge).  ``compacted`` is OUR reference to the
        swapped-in index, so its (state, translog_seq) pair stays
        consistent even if a racing ingest has already moved the engine
        past it -- the racer's ops sit after ``translog_seq`` in the log
        and replay on top of this commit."""
        seq = getattr(compacted, "translog_seq", None)
        if self._store is None or seq is None:
            return
        try:
            self._store.commit(compacted, seq)
            self.commits += 1
        except Exception as exc:  # noqa: BLE001 - disk faults not fatal
            self.failures.append({"group": g, "commit_seq": seq,
                                  "error": repr(exc)})

    def probe_once(self) -> int:
        """Canary-probe every FAULTED group; readmit the ones that
        answer.  Returns groups re-admitted.  The canary goes through the
        group's real batcher (the honest path -- a group is healthy when
        it can serve, not when a side channel says so); routing never
        sees it because routing already avoids down groups.

        Canaries are tracked as in-flight futures: a FRESH canary gets a
        bounded ``probe_timeout_s`` window (so the deterministic
        ``probe_once()`` re-admits a responsive group in one call), but a
        canary that is still pending after that is left in flight and
        merely polled on later ticks -- a HUNG group costs its window
        once, not per tick, and can never starve the compaction sweeps
        sharing this thread.  Re-admission goes through
        ``HealthMap.readmit`` (atomic mark-up-unless-drained), so an
        operator drain recorded while the canary was in flight survives
        its success."""
        if self._health is None:
            return 0
        is_drained = getattr(self._health, "is_drained", lambda g: False)
        readmit = getattr(self._health, "readmit", self._health.mark_up)
        readmitted = 0
        for g, batcher in enumerate(self._batchers):
            if self._health.is_up(g) or is_drained(g):
                self._probes.pop(g, None)   # stale canary: nobody to admit
                continue
            fut = self._probes.get(g)
            if fut is None:
                try:
                    canary = np.ones((batcher.index.n_features,),
                                     np.float32)
                    fut = batcher.submit(canary)
                except Exception:  # noqa: BLE001 - closed/broken batcher
                    continue
                self._probes[g] = fut
                try:
                    fut.result(timeout=self.probe_timeout_s)
                except Exception:  # noqa: BLE001 - timeout OR canary error
                    pass
            if not fut.done():
                continue                    # hung: poll again next tick
            self._probes.pop(g, None)
            try:
                if fut.exception() is not None:
                    continue                # still faulty: steady state
            except BaseException:           # noqa: BLE001 - cancelled
                continue
            if readmit(g):
                readmitted += 1
                self.probe_events.append({"group": g})
                self.metrics.counter("maintenance.probe.readmits",
                                     group=g).inc()
        return readmitted

    def _run(self) -> None:
        tick = self.interval_s
        if self.probe:
            tick = min(tick, self.probe_interval_s)
        poll_at = probe_at = 0.0
        while not self._stop_evt.wait(tick):
            now = time.monotonic()
            if now >= poll_at:
                self.poll_once()
                poll_at = time.monotonic() + self.interval_s
            if self.probe and now >= probe_at:
                self.probe_once()
                probe_at = time.monotonic() + self.probe_interval_s
