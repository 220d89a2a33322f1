"""Threshold slow log with tail-based capture (the ES index/search slow log).

The Tracer's 1/16 head sampling answers "what does a typical request
look like" -- but the requests an operator actually needs are exactly
the ones head sampling usually drops: the slow ones and the failed
ones.  Tail-based capture fixes the selection bias:

* EVERY request gets a lightweight span skeleton -- a real
  :class:`~repro_torch.obs.tracing.Trace` whose retention sink is this slow
  log (creation cost: one small object; the spans were being recorded
  into NULL_TRACE-shaped call sites anyway);
* at ``finish()`` the skeleton is retained only if total latency
  crossed ``threshold_s`` or the request errored -- promoted to a full
  record with its :func:`~repro_torch.obs.profile.profile_from_trace` tree --
  otherwise it is dropped on the floor.  Slow queries are captured at
  100% regardless of the head-sampling rate.

Retention is a bounded ring (newest ``capacity`` records) plus an
optional append-only JSONL sink (``path=``), one JSON object per
captured request -- the grep-able ES slow-log file.

:func:`start_request_trace` is the one admission helper every submit
path uses: with a slow log attached, a head-sampled request gets ONE
trace retained by BOTH sinks (tracer ring + slow-log threshold check,
via a fan-out retainer) and an unsampled request gets a slow-log-only
skeleton; with no slow log, behavior is exactly the old tracer path.
"""

from __future__ import annotations

import itertools
import json
import threading
from collections import deque
from typing import List, Optional

from .metrics import default_registry
from .profile import profile_from_trace
from .tracing import NULL_TRACE, Trace

__all__ = ["SlowLog", "start_request_trace"]


class _Fanout:
    """Retention sink that forwards a finished trace to several sinks
    (the tracer's ring AND the slow log's threshold check)."""

    __slots__ = ("sinks",)

    def __init__(self, *sinks):
        self.sinks = sinks

    def _retain(self, trace) -> None:
        for s in self.sinks:
            s._retain(trace)


class SlowLog:
    """Tail-based capture of slow/failed requests.

    ``threshold_s=0.0`` captures every finished request (the smoke-run
    configuration -- capture then reconciles exactly with requests
    seen); errors are captured regardless of latency.  Counters land in
    ``metrics`` (``slowlog.seen`` / ``slowlog.captured`` /
    ``slowlog.errors``) so the stats rollup and exporter see capture
    rates without touching the ring.
    """

    def __init__(self, threshold_s: float = 0.1, capacity: int = 256,
                 path: Optional[str] = None, metrics=None):
        if threshold_s < 0:
            raise ValueError(f"threshold_s must be >= 0, got {threshold_s}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.threshold_s = float(threshold_s)
        self.path = path
        self.metrics = metrics if metrics is not None else default_registry()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        # lock-free seen counting, the Tracer admission pattern
        self._counter = itertools.count()
        self._n_seen = 0
        self._n_slow = 0
        self._n_errors = 0
        self._file = None
        self._c_seen = self.metrics.counter("slowlog.seen")
        self._c_captured = self.metrics.counter("slowlog.captured")
        self._c_errors = self.metrics.counter("slowlog.errors")

    # ----------------------------------------------------------- admission
    def start(self, name: str = "query", **attrs) -> Trace:
        """The span skeleton: a real Trace whose retention sink is this
        slow log.  Every request gets one -- the threshold decides at
        finish() whether it survives."""
        n = next(self._counter)
        self._n_seen = n + 1
        self._c_seen.inc()
        return Trace(name, n + 1, tracer=self, **attrs)

    def _note_seen(self) -> None:
        """Count a request whose skeleton the TRACER created (the
        head-sampled path of :func:`start_request_trace`) so ``seen``
        means every request, not just slow-log-created skeletons."""
        n = next(self._counter)
        self._n_seen = n + 1
        self._c_seen.inc()

    # ----------------------------------------------------------- retention
    def _retain(self, trace) -> None:
        """Trace.finish() hands every skeleton here; keep it only past
        the threshold or on error (tail-based capture)."""
        t1 = trace.t1 if trace.t1 is not None else trace.t0
        duration = t1 - trace.t0
        error = trace.attrs.get("error")
        if error is None and duration < self.threshold_s:
            return
        record = trace.to_dict()
        record["slowlog"] = {
            "reason": "error" if error is not None else "slow",
            "duration_s": duration,
            "threshold_s": self.threshold_s,
        }
        # the promotion: a captured request carries its full profile tree
        record["profile"] = profile_from_trace(record)
        with self._lock:
            if error is not None:
                self._n_errors += 1
            else:
                self._n_slow += 1
            self._ring.append(record)
            f = self._file
            if f is None and self.path is not None:
                f = self._file = open(self.path, "a", encoding="utf-8")
            if f is not None:
                f.write(json.dumps(record) + "\n")
                f.flush()
        self._c_captured.inc()
        if error is not None:
            self._c_errors.inc()

    # ---------------------------------------------------------------- reads
    def dump(self, clear: bool = False) -> List[dict]:
        """Captured records, oldest first (each carries its trace spans,
        the slowlog reason/threshold block, and the promoted profile
        tree)."""
        with self._lock:
            out = list(self._ring)
            if clear:
                self._ring.clear()
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "seen": self._n_seen,
                "captured": self._n_slow + self._n_errors,
                "slow": self._n_slow,
                "errors": self._n_errors,
                "retained": len(self._ring),
                "capacity": self._ring.maxlen,
                "threshold_s": self.threshold_s,
            }

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


def start_request_trace(tracer, slowlog, name: str = "query", **attrs):
    """One admission point for every submit path.

    * no tracer, no slow log -> :data:`~repro_torch.obs.tracing.NULL_TRACE`;
    * tracer only -> the tracer's head-sampled admission (old behavior);
    * slow log attached -> every request gets a skeleton: head-sampled
      requests get ONE trace fanned out to both sinks, the rest get a
      slow-log-only skeleton.  Either way a slow or failed request is
      captured at 100%.
    """
    if slowlog is None:
        if tracer is None:
            return NULL_TRACE
        return tracer.start(name, **attrs)
    if tracer is not None:
        t = tracer.start(name, **attrs)
        if t:
            t._tracer = _Fanout(tracer, slowlog)
            slowlog._note_seen()
            return t
    return slowlog.start(name, **attrs)
