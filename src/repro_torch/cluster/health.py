"""Replica-group health map (the ES cluster-state routing table).

:class:`HealthMap` tracks which replica groups are routable.  It is the
cluster's single source of routing truth, the analogue of Elasticsearch's
cluster state marking shard copies ``STARTED`` vs ``UNASSIGNED``: the
router consults it on every pick, failover marks a group down when a
search against it fails, and an operator (or test) flips groups with
``mark_down``/``mark_up`` the way ES applies shard-failed cluster-state
updates.

Marking a group down is a ROUTING decision only -- requests already queued
on the group's batcher drain normally (the index may be perfectly healthy,
e.g. a rolling restart); only new picks avoid it.  Actually-dead groups
are handled one level up: the router's failure path marks the group down
*and* resubmits the failed requests to a surviving copy.

Two kinds of down (the ES allocation-``exclude`` vs shard-failed
distinction): ``mark_down(g)`` records a FAULT -- the canary prober
(:meth:`~repro_torch.cluster.maintenance.MaintenanceDaemon.probe_once`) may
re-admit the group once it answers again; ``mark_down(g, drain=True)``
records OPERATOR INTENT -- the group is deliberately out of routing
(rolling restart, debugging) and stays down, however healthy its
canaries look, until an explicit ``mark_up``.  ``mark_up`` clears both.

Thread-safe; every mutation bumps ``generation`` (ES cluster-state
version) so pollers can cheaply detect change.

Health *transitions* are the cluster's availability ledger, so they are
metered (:mod:`repro_torch.obs.metrics`): ``health.down_transitions`` /
``health.mark_ups`` / ``health.readmits`` count per-group state CHANGES
(a re-mark of an already-down group counts nothing), which is what lets
the stats layer assert "one injected failure == one down/readmit pair".
On top of the counters, a bounded in-memory ledger
(:meth:`HealthMap.transitions`) records each transition with the
generation it produced, so ``cluster_health()`` can reconcile its
green/yellow/red verdict EXACTLY against the event history: the number
of ``down`` ledger events must equal the ``health.down_transitions``
counter total, and replaying the ledger must land on the current
down-set (the stats schema's reconciliation contract, applied to availability).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Tuple

# transitions kept for reconciliation; ES keeps a similarly bounded
# cluster-state update log.  Old entries fall off but the counters keep
# exact lifetime totals.
_LEDGER_CAPACITY = 1024

from repro_torch.obs.metrics import default_registry

__all__ = ["HealthMap"]


class HealthMap:
    def __init__(self, n_groups: int, metrics=None):
        if n_groups < 1:
            raise ValueError(f"need at least one replica group, got {n_groups}")
        self.n_groups = n_groups
        self.metrics = metrics if metrics is not None else default_registry()
        self._down: set = set()
        self._drained: set = set()
        self._lock = threading.Lock()
        self._generation = 0
        self._events: deque = deque(maxlen=_LEDGER_CAPACITY)

    def _log(self, event: str, group: int) -> None:
        """Append one transition to the ledger.  Caller holds ``_lock``
        and has already bumped ``generation`` -- the recorded generation
        is the one this transition produced."""
        self._events.append({"event": event, "group": group,
                             "generation": self._generation})

    def _check(self, group: int) -> None:
        if not 0 <= group < self.n_groups:
            raise ValueError(
                f"group must be in [0, {self.n_groups}), got {group}")

    def mark_down(self, group: int, drain: bool = False) -> bool:
        """Stop routing to ``group``; returns True if anything changed
        (down flipped OR a new drain intent was recorded -- both bump
        ``generation``).  ``drain=True`` records operator intent: the
        group is exempt from canary re-admission until an explicit
        :meth:`mark_up` (draining an already-down group still records
        the intent)."""
        self._check(group)
        with self._lock:
            changed = False
            went_down = False
            drained = False
            if drain and group not in self._drained:
                self._drained.add(group)
                changed = drained = True
            if group not in self._down:
                self._down.add(group)
                changed = went_down = True
            if changed:
                self._generation += 1
            if went_down:
                self._log("down", group)
            if drained:
                self._log("drain", group)
        if went_down:
            self.metrics.counter("health.down_transitions", group=group).inc()
        return changed

    def mark_up(self, group: int) -> bool:
        """Restore routing to ``group``, clearing any drain intent (this
        is the operator's explicit rejoin); returns True if the ROUTING
        state changed (a drain-only clear still bumps ``generation``)."""
        self._check(group)
        with self._lock:
            was_drained = group in self._drained
            came_up = group in self._down
            if was_drained or came_up:
                self._generation += 1
            self._drained.discard(group)
            self._down.discard(group)
            if came_up:
                self._log("up", group)
            elif was_drained:
                self._log("undrain", group)
        if came_up:
            self.metrics.counter("health.mark_ups", group=group).inc()
        return came_up

    def readmit(self, group: int) -> bool:
        """``mark_up`` UNLESS an operator drain is in force -- atomic, so
        a drain recorded while a canary was in flight can never be undone
        by its success (the prober's and the failover rollback's entry
        point; only the operator's :meth:`mark_up` clears a drain)."""
        self._check(group)
        with self._lock:
            if group in self._drained or group not in self._down:
                return False
            self._down.discard(group)
            self._generation += 1
            self._log("readmit", group)
        self.metrics.counter("health.readmits", group=group).inc()
        return True

    def transitions(self) -> Tuple[dict, ...]:
        """The transition ledger, oldest first: ``{"event": "down" |
        "drain" | "up" | "undrain" | "readmit", "group": g,
        "generation": gen}`` per state change.  ``down`` entries match
        the ``health.down_transitions`` counter one-for-one (likewise
        ``up``/``mark_ups`` and ``readmit``/``readmits``) until the
        bounded ledger wraps -- the exact-reconciliation seam
        ``cluster_health()`` checks."""
        with self._lock:
            return tuple(dict(e) for e in self._events)

    def is_drained(self, group: int) -> bool:
        """True while an operator drain (``mark_down(g, drain=True)``)
        is in force -- the prober must not re-admit such a group."""
        self._check(group)
        with self._lock:
            return group in self._drained

    def is_up(self, group: int) -> bool:
        self._check(group)
        with self._lock:
            return group not in self._down

    def up_groups(self) -> Tuple[int, ...]:
        """Routable groups, ascending (possibly empty: a full outage)."""
        with self._lock:
            return tuple(g for g in range(self.n_groups)
                         if g not in self._down)

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def snapshot(self) -> dict:
        with self._lock:
            return {"n_groups": self.n_groups,
                    "down": tuple(sorted(self._down)),
                    "drained": tuple(sorted(self._drained)),
                    "generation": self._generation}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        s = self.snapshot()
        return (f"HealthMap({s['n_groups']} groups, down={s['down']}, "
                f"gen={s['generation']})")
