"""Per-request span traces (the ES slow-log + tasks-API + profile layer).

A :class:`Trace` follows ONE query through the serving stack as a list
of host-side spans -- ``submit`` -> queue wait -> batch formation ->
device dispatch -- with point-in-time *events* for the control-plane
things that happen to it on the way.  This is what ES scatters across
three APIs: the slow log (per-query phase timings), the tasks API (where
is my request right now), and the profile API (per-phase breakdown);
here it is one object per request.

Discipline (same as :mod:`repro_torch.obs.metrics`): spans carry
host-side timestamps taken *around* the search dispatch, never inside a
kernel -- tracing can never change what the card computes.  To line host
spans up with what the device actually did, ``annotation(name)``
optionally opens a ``torch.profiler.record_function`` range around the
dispatch (enabled via ``Tracer(annotate=True)``): when a
``torch.profiler`` trace is being captured, the host span names then
appear on the profiler's timeline around the kernels they enclose, and
cost next to nothing when no profiler is recording.

Retention is a bounded ring buffer (``capacity`` most recent finished
traces, ES ``tasks``-style dump-on-demand via :meth:`Tracer.dump`), and
admission is sampled: ``sample=1/16`` keeps one query in 16 (counter-
based, deterministic -- no RNG on the hot path).  Unsampled queries get
the singleton :data:`NULL_TRACE` whose every method is a no-op, so call
sites never branch.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import List, Optional

__all__ = ["Span", "Trace", "Tracer", "NULL_TRACE", "annotation"]


def annotation(name: str, enabled: bool = True):
    """Context manager: a ``torch.profiler.record_function`` range around
    a dispatch when enabled, else a no-op.  Host-side only -- it never
    changes what is launched or computed."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


class Span:
    """One timed phase of a request.  ``t0``/``t1`` are
    ``time.monotonic()`` seconds; ``attrs`` are small scalars (group,
    batch size); ``events`` are (name, t, attrs) points."""

    __slots__ = ("name", "t0", "t1", "attrs", "events")

    def __init__(self, name: str, t0: Optional[float] = None, **attrs):
        self.name = name
        self.t0 = time.monotonic() if t0 is None else t0
        self.t1: Optional[float] = None
        self.attrs = attrs
        self.events: List[tuple] = []

    def end(self, t1: Optional[float] = None) -> "Span":
        self.t1 = time.monotonic() if t1 is None else t1
        return self

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def to_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "duration_s": self.duration_s, "attrs": dict(self.attrs),
                "events": [{"name": n, "t": t, "attrs": a}
                           for n, t, a in self.events]}


class Trace:
    """All spans + events for one request.  Thread-safe: the submitting
    thread, the batcher worker, and the failover callback all append
    concurrently (a failed-over query's spans come from two different
    group workers)."""

    __slots__ = ("name", "trace_id", "t0", "t1", "attrs", "_spans",
                 "_lock", "_tracer")

    def __init__(self, name: str, trace_id: int,
                 tracer: Optional["Tracer"] = None, **attrs):
        self.name = name
        self.trace_id = trace_id
        self.t0 = time.monotonic()
        self.t1: Optional[float] = None
        self.attrs = attrs
        self._spans: List[Span] = []
        self._lock = threading.Lock()
        self._tracer = tracer

    def span(self, name: str, t0: Optional[float] = None,
             t1: Optional[float] = None, **attrs) -> Span:
        """Append a span; with ``t1`` given it is already closed (the
        batcher records queue-wait/dispatch spans after the fact, from
        the SAME clock reads its own accounting uses, so the trace and
        the batcher can never disagree on a wait)."""
        s = Span(name, t0=t0, **attrs)
        if t1 is not None:
            s.end(t1)
        with self._lock:
            self._spans.append(s)
        return s

    def event(self, name: str, **attrs) -> None:
        """Point-in-time control-plane event (spill, resubmit, down,
        readmit), attached to the most recent open span or the trace
        root."""
        t = time.monotonic()
        with self._lock:
            for s in reversed(self._spans):
                if s.t1 is None:
                    s.events.append((name, t, attrs))
                    return
            self._spans.append(Span("events", t0=t))
            self._spans[-1].events.append((name, t, attrs))
            self._spans[-1].end(t)

    def finish(self, error: Optional[str] = None) -> None:
        """Close the trace and hand it to the tracer's ring buffer.
        Idempotent: resubmit races finish exactly once."""
        with self._lock:
            if self.t1 is not None:
                return
            self.t1 = time.monotonic()
            if error is not None:
                self.attrs["error"] = error
        if self._tracer is not None:
            self._tracer._retain(self)

    @property
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def to_dict(self) -> dict:
        with self._lock:
            spans = list(self._spans)
            return {"name": self.name, "trace_id": self.trace_id,
                    "t0": self.t0, "t1": self.t1,
                    "duration_s": (None if self.t1 is None
                                   else self.t1 - self.t0),
                    "attrs": dict(self.attrs),
                    "spans": [s.to_dict() for s in spans]}


class _NullTrace:
    """Do-nothing stand-in for unsampled requests: call sites record
    unconditionally, the null trace swallows it all at attribute-call
    cost.  Falsy, so ``if trace:`` skips optional extra work."""

    __slots__ = ()

    def span(self, name, t0=None, t1=None, **attrs):
        return self

    def event(self, name, **attrs):
        return None

    def finish(self, error=None):
        return None

    def end(self, t1=None):
        return self

    def to_dict(self):
        return {}

    def __bool__(self):
        return False


NULL_TRACE = _NullTrace()


class Tracer:
    """Sampled per-request trace factory + bounded retention.

    ``sample`` is the admission fraction (1.0 = every request, the
    default 1/16 keeps steady-state overhead negligible while still
    surfacing one full trace per batch on average); admission is a
    deterministic counter (every ``round(1/sample)``-th start), so runs
    reproduce.  ``capacity`` bounds retained finished traces (oldest
    evicted).  ``annotate=True`` additionally opens
    ``torch.profiler.record_function`` ranges around the dispatch so host
    spans line up with captured device profiles.
    """

    def __init__(self, capacity: int = 256, sample: float = 1.0 / 16,
                 annotate: bool = False):
        if not 0.0 < sample <= 1.0:
            raise ValueError(f"sample must be in (0, 1], got {sample}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.sample = sample
        self.period = max(1, round(1.0 / sample))
        self.annotate = annotate
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        # admission draws from an itertools counter (C-level atomic, so
        # the sampled-OUT path -- the common case -- takes no lock);
        # _n_seen mirrors it for stats() and is exact when starts don't
        # race each other
        self._counter = itertools.count()
        self._n_started = 0
        self._n_seen = 0

    def start(self, name: str = "query", **attrs) -> "Trace | _NullTrace":
        """Admit (or null-admit) one request.  Sampled-out requests get
        :data:`NULL_TRACE` -- lock-free, a counter draw and a modulo."""
        n = next(self._counter)
        self._n_seen = n + 1
        if n % self.period:
            return NULL_TRACE
        with self._lock:
            self._n_started += 1
            tid = self._n_started
        return Trace(name, tid, tracer=self, **attrs)

    def _retain(self, trace: Trace) -> None:
        with self._lock:
            self._ring.append(trace)

    def dump(self, clear: bool = False) -> List[dict]:
        """Finished traces, oldest first, as plain dicts (the
        dump-on-demand ES ``tasks``/slow-log read path)."""
        with self._lock:
            out = [t.to_dict() for t in self._ring]
            if clear:
                self._ring.clear()
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"seen": self._n_seen, "sampled": self._n_started,
                    "retained": len(self._ring),
                    "capacity": self._ring.maxlen, "sample": self.sample}
