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

**The serving path's timeline** (:class:`Timeline`, owned by a
:class:`~repro_torch.obs.metrics.MetricsRegistry` as
``registry.timeline``) is the other half: not one request's spans but
every serving thread's, written where the work happens.  The span names,
in :data:`SPAN_NAMES`:

* ``batcher.wait`` (loop top to dequeue), ``batcher.form`` (dequeue to
  dispatch), ``search.launch`` (dispatch to just before the answers'
  copies), ``search.answer_wait`` (the two copies) and
  ``batcher.deliver`` (futures resolved, the batch let go): they share
  their edges, so they tile each batcher loop, and the spans of one
  batch share its batch id;
* ``search.encode``, ``search.phase1`` (its args: shards, generations),
  ``search.merge`` and ``search.rescore``: children of ``search.launch``,
  closed where a profiled search files its phase but with no fence, so
  they time the host's issue of the work, not the card's.  A batch
  answered by a CUDA graph's replay (:mod:`repro_torch.serve.graphs`)
  issues none of that work: its launch has one child,
  ``search.replay``, the queries' write into the graph's input and the
  replay's launch;
* ``ingest.add`` (inside the engine lock) and its child
  ``ingest.seal``; ``maintenance.merge`` (a rebuild, its args: outcome,
  kind); ``router.pick`` (a routed submit's group choice);
* children of ``search.phase1``, which keeps its meaning and its args:
  on the ``postings`` engine's walk (:mod:`repro_torch.core.postings`),
  ``search.postings.sync``, the host blocked reading the entry counts
  per column (its args: the kept tokens with a non-empty posting list,
  and the columns that hold any; the kept tokens' ``nonzero`` just
  before it waits for the card too, for its output's size), then
  ``search.postings.walk``, from the sync's return until the last
  ``index_add_`` round is issued; on the ``codes`` engine
  (:mod:`repro_torch.core.codes`), ``search.codes.score``, the issue of
  its block loop, from the first doc block until the last block's
  ``bmm`` and its write are issued (its args: the doc blocks, and the
  docs a block); on the flat index's composed path
  (``postings``, ``codes``, ``onehot``, ``codes_pallas``),
  ``search.topk``, the page's stable top-``page`` of the (Q, n_docs)
  scores (``select_page``: on the card the ``page_select`` kernels).
  Unfenced like their parent: the walk's span ends when its rounds are
  issued, not run.

The walk also feeds three always-on counters, which the engine keeps
beside ``engine.graph.*`` (labelled ``group`` under a router), from the
host integers its sync already read: ``search.postings.entries``,
the posting entries walked (the sum, over the batch's kept tokens, of
each token's document frequency, capped at ``max_postings`` where set);
``search.postings.tokens``, the kept tokens with a non-empty list; and
``search.postings.rounds``, the ``index_add_`` rounds issued, one a
column that holds an entry.  A batch of another engine adds nothing.
Beside them, ``search.page_select.rows{engine}`` counts the rows whose
page ``select_page`` cut from a composed engine's dense scores (``Q`` a
search on the flat index, ``Q`` a shard on a sharded one); a batch of a
page kernel (``fused``, ``fused_int8``) adds nothing.  The ``codes``
engine feeds two more, from the host integers of its shapes:
``search.codes.cells``, the (query, doc, column) comparisons, Q·d·C a
table scored, and ``search.codes.blocks``, the doc blocks its loop
walked; a sharded index's bases count, its generations (scored by
``code_match``, which no cell runs) do not, and another engine adds
nothing.

Each span is one row of a ring of :data:`TIMELINE_CAPACITY` rows of a
preallocated numpy array (start and end in ``time.monotonic_ns``, name
id, native thread id, span id, parent span id, batch id, group, two
integer args), written by one ``struct.pack_into``: recording keeps no
Python object, takes no lock, and a wrapped ring counts each
overwritten span in the counter ``timeline.dropped``.  The index code
cannot see the registry, so the engine sets a :class:`Sink` as the
thread's active one around a dispatch or an add, and
:func:`phase_clock` finds it there; :func:`child_clock` finds the phase
a :class:`PhaseClock` has open under it, the parent of a nested span.

The timeline records only while a ``torch.profiler`` session records
and the registry is enabled.  The check is the profiler's process-wide
flag, ``torch.autograd.profiler._is_profiler_enabled``, which a session
sets for every thread (``torch._C._autograd._profiler_enabled()`` answers
for the calling thread only, and is False on a batcher's thread while
the main thread profiles).  Off, a span site costs that one check and
allocates nothing, and nothing opens a profiler range.

``registry.snapshot()`` carries a ``timeline`` section while spans are
held (:meth:`Timeline.snapshot`), with an
anchor pair -- ``time.time_ns()`` and ``time.monotonic_ns()`` read back
to back -- that maps every span onto the profiler's clock, the wall
clock of ``time.time_ns``: ``wall = t + anchor.wall_ns -
anchor.monotonic_ns``.  The Prometheus text, the JSONL history and the
diagnostics bundle leave the section out.
"""

from __future__ import annotations

import contextlib
import itertools
import struct
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np
from torch.autograd import profiler as _autograd_profiler

__all__ = ["Span", "Trace", "Tracer", "NULL_TRACE", "annotation",
           "Timeline", "Sink", "PhaseClock", "phase_clock", "child_clock",
           "SPAN_NAMES", "TIMELINE_CAPACITY", "to_ns"]


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
        # admission counts under the lock, so stats() is exact when
        # starts race each other
        self._n_started = 0
        self._n_seen = 0

    def start(self, name: str = "query", **attrs) -> "Trace | _NullTrace":
        """Admit (or null-admit) one request.  Sampled-out requests get
        :data:`NULL_TRACE` -- a count under an uncontended lock and a
        modulo."""
        with self._lock:
            n = self._n_seen
            self._n_seen = n + 1
            if n % self.period:
                return NULL_TRACE
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


# ------------------------------------------------------------- timeline
SPAN_NAMES = ("batcher.wait", "batcher.form", "search.launch",
              "search.encode", "search.phase1", "search.merge",
              "search.rescore", "search.answer_wait", "batcher.deliver",
              "ingest.add", "ingest.seal", "maintenance.merge",
              "router.pick", "search.replay", "search.postings.sync",
              "search.postings.walk", "search.topk", "search.codes.score")
_NAME_ID = {n: i for i, n in enumerate(SPAN_NAMES)}
# what a span's two integer args hold, by span name (0 elsewhere)
SPAN_ARGS = {"search.phase1": ("shards", "generations"),
             "maintenance.merge": ("outcome", "kind"),
             "search.postings.sync": ("tokens", "columns"),
             "search.codes.score": ("blocks", "docs_per_block")}
MERGE_OUTCOMES = ("applied", "discarded", "failed")
MERGE_KINDS = ("merge", "compact")
TIMELINE_CAPACITY = 1 << 18
_SPAN_ROW = np.dtype([("t0_ns", "<i8"), ("t1_ns", "<i8"), ("name", "<i4"),
                      ("group", "<i4"), ("thread", "<i8"), ("span", "<i8"),
                      ("parent", "<i8"), ("batch", "<i8"), ("arg0", "<i4"),
                      ("arg1", "<i4")])
# one row's bytes, field for field: a span is one C call that writes it
_PACK_ROW = struct.Struct("<qqiiqqqqii").pack_into


class _Local(threading.local):
    sink: "Optional[Sink]" = None     # this thread's active Sink
    tid = 0                           # its native id, read once


_TLS = _Local()


def _native_tid() -> int:
    _TLS.tid = threading.get_native_id()     # a system call: read once
    return _TLS.tid


def to_ns(t: float) -> int:
    """A ``time.monotonic()`` read in ``time.monotonic_ns()`` units (the
    same clock), so a span takes the reads a histogram took."""
    return round(t * 1e9)


class Sink:
    """Where the index code's spans go while the engine serves one batch
    or one add on this thread: the timeline, the span they are children
    of (``parent``, an id drawn when the sink is made), the batch and the
    group.  ``with sink:`` makes it the thread's active sink;
    ``t_copy`` is the engine's clock read just before the answers'
    copies; ``phase`` is the id of the phase a :class:`PhaseClock` has
    open under it (0 before the first)."""

    __slots__ = ("timeline", "parent", "batch", "group", "t_copy", "phase",
                 "_prev")

    def __init__(self, timeline: "Timeline", batch: int, group: int):
        self.timeline, self.batch, self.group = timeline, batch, group
        self.parent = next(timeline._ids)
        self.t_copy: Optional[float] = None
        self.phase = 0

    def __enter__(self):
        self._prev = _TLS.sink
        _TLS.sink = self
        return self

    def __exit__(self, *exc):
        _TLS.sink = self._prev
        return False


class PhaseClock:
    """Closes consecutive phases of one search or add as child spans of
    the active sink's span (``parent`` None), or of span ``parent``: each
    from the last boundary to now.  The id of the span it closes next is
    drawn when the last one closes, so a phase's children can name it
    while it is open: a clock of the sink's phases publishes it as
    ``sink.phase``."""

    __slots__ = ("sink", "t", "parent", "span")

    def __init__(self, sink: Sink, parent: Optional[int] = None):
        self.sink, self.parent = sink, parent
        self.t = time.monotonic_ns()
        self._open()

    def _open(self) -> None:
        self.span = next(self.sink.timeline._ids)
        if self.parent is None:
            self.sink.phase = self.span

    def close(self, name: str, arg0: int = 0, arg1: int = 0) -> None:
        t = time.monotonic_ns()
        s = self.sink
        s.timeline.record(name, self.t, t, span=self.span,
                          parent=s.parent if self.parent is None
                          else self.parent, batch=s.batch, group=s.group,
                          arg0=arg0, arg1=arg1)
        self.t = t
        self._open()


def phase_clock() -> Optional[PhaseClock]:
    """A :class:`PhaseClock` from now on this thread's active sink, or
    None where the engine set none (no profiler was recording when the
    batch or the add began).  Off, a search pays this one look-up."""
    sink = _TLS.sink
    return None if sink is None else PhaseClock(sink)


def child_clock() -> Optional[PhaseClock]:
    """A :class:`PhaseClock` from now whose spans are children of the
    phase open on this thread's active sink (of the sink's span before
    any phase), or None where there is no sink: the same one look-up
    off."""
    sink = _TLS.sink
    return None if sink is None else PhaseClock(
        sink, sink.phase or sink.parent)


class Timeline:
    """The ring of the serving threads' spans (module docstring).
    ``registry`` receives ``timeline.dropped``; ``capacity`` rows are
    allocated at the first span recorded, never before."""

    def __init__(self, registry, capacity: int = TIMELINE_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._registry = registry
        self._rows: Optional[np.ndarray] = None
        self._bytes: Optional[memoryview] = None     # the rows' memory
        self._alloc_lock = threading.Lock()
        self._slots = itertools.count()
        self._ids = itertools.count(1)        # span ids; 0 marks a free row
        self._batches = itertools.count(1)

    def recording(self) -> bool:
        """Whether a span recorded now is kept: a ``torch.profiler``
        session records and the registry is enabled."""
        return (_autograd_profiler._is_profiler_enabled
                and self._registry.enabled)

    def new_batch(self) -> int:
        """The next batch id (drawn for every batch, recorded or not: the
        per-request traces carry it)."""
        return next(self._batches)

    def sink(self, batch: int = 0, group: Optional[int] = None) -> Sink:
        return Sink(self, batch, -1 if group is None else group)

    def record(self, name: str, t0_ns: int, t1_ns: int, *, span: int = 0,
               parent: int = 0, batch: int = 0, group: int = -1,
               arg0: int = 0, arg1: int = 0) -> None:
        """Write one finished span (``span`` 0: draw its id)."""
        buf = self._bytes if self._bytes is not None else self._allocate()
        slot = next(self._slots)
        if slot >= self.capacity:
            self._registry.counter("timeline.dropped").inc()
        # the whole row in one call: a snapshot sees it whole or not
        _PACK_ROW(buf, (slot % self.capacity) * _SPAN_ROW.itemsize, t0_ns,
                  t1_ns, _NAME_ID[name], group, _TLS.tid or _native_tid(),
                  span or next(self._ids), parent, batch, arg0, arg1)

    def record_batch(self, sink: Sink, t_top: Optional[float], t_deq: float,
                     t_dispatch: float, t_done: float, t_end: float) -> None:
        """The five batcher spans of one batch, from the engine's shared
        ``time.monotonic()`` reads, so they tile its loop; ``t_top`` None
        (the loop's top came before a profiler recorded) leaves out
        ``batcher.wait``.  ``search.launch`` takes the sink's id, the
        parent of the index's phases."""
        t_copy = t_done if sink.t_copy is None else sink.t_copy
        kw = dict(batch=sink.batch, group=sink.group)
        if t_top is not None:
            self.record("batcher.wait", to_ns(t_top), to_ns(t_deq), **kw)
        self.record("batcher.form", to_ns(t_deq), to_ns(t_dispatch), **kw)
        self.record("search.launch", to_ns(t_dispatch), to_ns(t_copy),
                    span=sink.parent, **kw)
        self.record("search.answer_wait", to_ns(t_copy), to_ns(t_done),
                    **kw)
        self.record("batcher.deliver", to_ns(t_done), to_ns(t_end), **kw)

    def _allocate(self) -> memoryview:
        with self._alloc_lock:
            if self._rows is None:
                rows = np.zeros(self.capacity, _SPAN_ROW)
                self._bytes = memoryview(rows).cast("B")
                self._rows = rows
        return self._bytes

    def snapshot(self) -> Optional[dict]:
        """The held spans, oldest start first, as one array per field
        under ``spans``, with the anchor, the name table, the args'
        meanings and ``dropped``; None while no span is held."""
        if self._rows is None:
            return None
        # bytes() copies under the interpreter lock, which no row write
        # can interleave with (numpy's own copy may release it)
        rows = np.frombuffer(bytes(self._bytes), _SPAN_ROW)
        held = rows[rows["span"] > 0]
        held = held[np.argsort(held["t0_ns"], kind="stable")]
        wall = time.time_ns()
        mono = time.monotonic_ns()
        return {"anchor": {"wall_ns": wall, "monotonic_ns": mono},
                "names": list(SPAN_NAMES),
                "args": {n: list(a) for n, a in SPAN_ARGS.items()},
                "codes": {"outcome": list(MERGE_OUTCOMES),
                          "kind": list(MERGE_KINDS)},
                "spans": {f: held[f].copy() for f in _SPAN_ROW.names},
                "dropped": int(self._registry.value("timeline.dropped"))}
