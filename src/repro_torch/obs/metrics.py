"""Thread-safe metrics registry: counters, gauges, log-bucketed histograms.

The node-stats layer of the observability plane (the data behind ES
``GET _nodes/stats`` and ``_cat/thread_pool``): every serving component
records into one :class:`MetricsRegistry`, and the ES-style ``stats()``
snapshots (:mod:`repro_torch.obs.stats`) read it back out.  Three
instrument kinds, all label-aware (``registry.counter(
"engine.requests.completed", group=0)`` and ``group=1`` are independent
series, the way ES stats key by node/index/shard):

* :class:`Counter` -- monotonic event count (requests served, swaps);
* :class:`Gauge` -- last-write-wins level (queue depth, batch occupancy
  at this instant);
* :class:`Histogram` -- log-bucketed latency distribution with exact
  ``count``/``sum``/``min``/``max`` and bucketed p50/p90/p99/p999.

Design constraints, in order:

1. **Off the device.**  Nothing here touches the card; instruments record
   host-side timestamps taken around the search dispatch only, so
   instrumentation can never change what a kernel computes.
2. **Low overhead.**  One ``threading.Lock`` acquisition and O(1) work
   (bisect over precomputed bucket bounds for histograms) per record.
3. **Switchable.**  ``registry.enabled = False`` turns every record into
   a single attribute check and nothing else -- the bare configuration
   of the serving engine.

Histogram bucket math (the JAX package's, bound for bound, so one
sequence of observations gives equal snapshots in both): bucket *i* has
upper bound ``LOW * GROWTH**i`` (LOW = 1e-6 s, GROWTH = 2**0.25, i.e.
~19% relative width, 1 us .. >100 s in 108 buckets).  A sample lands in
the first bucket whose bound is >= the sample (Prometheus ``le``
semantics); quantiles report the *upper bound* of the bucket holding the
q-th sample, so a reported p99 is a guaranteed upper bound with at most
one bucket (~19%) of relative error.  ``bucket_le(x)`` exposes the
mapping so tests can compute expected quantiles exactly.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Dict, Tuple

from .tracing import Timeline

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry"]

# histogram geometry: LOW * GROWTH**i upper bounds, 1 us .. >100 s
_HIST_LOW = 1e-6
_HIST_GROWTH = 2.0 ** 0.25
_HIST_BUCKETS = 108
_HIST_BOUNDS = tuple(_HIST_LOW * _HIST_GROWTH ** i
                     for i in range(_HIST_BUCKETS))


def _labels_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    """Canonical hashable label identity: sorted (key, str(value))."""
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Instrument:
    """Shared plumbing: every record checks the owning registry's
    ``enabled`` flag first, so a disabled registry costs one attribute
    load per call site and mutates nothing."""

    __slots__ = ("name", "labels", "_registry", "_lock")

    def __init__(self, name: str, labels: Tuple, registry: "MetricsRegistry"):
        self.name = name
        self.labels = labels
        self._registry = registry
        self._lock = threading.Lock()


class Counter(_Instrument):
    """Monotonic event counter (ES stats ``*_total`` fields)."""

    __slots__ = ("_value",)

    def __init__(self, name, labels, registry):
        super().__init__(name, labels, registry)
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge(_Instrument):
    """Last-write-wins level (queue depth, occupancy)."""

    __slots__ = ("_value",)

    def __init__(self, name, labels, registry):
        super().__init__(name, labels, registry)
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Instrument):
    """Log-bucketed distribution: exact count/sum/min/max, bucketed
    quantiles (upper-bound semantics -- see module docstring)."""

    __slots__ = ("_counts", "_n", "_sum", "_min", "_max")

    def __init__(self, name, labels, registry):
        super().__init__(name, labels, registry)
        self._counts = [0] * (_HIST_BUCKETS + 1)   # +1: overflow bucket
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    @staticmethod
    def bucket_le(x: float) -> float:
        """The bucket upper bound ``x`` maps to -- the value quantiles
        report for any sample in that bucket.  Samples past the last
        bound map to +inf (the overflow bucket)."""
        i = bisect_left(_HIST_BOUNDS, x)
        return _HIST_BOUNDS[i] if i < _HIST_BUCKETS else math.inf

    def observe(self, x: float) -> None:
        if not self._registry.enabled:
            return
        x = float(x)
        i = bisect_left(_HIST_BOUNDS, x)
        with self._lock:
            self._counts[i] += 1
            self._n += 1
            self._sum += x
            if x < self._min:
                self._min = x
            if x > self._max:
                self._max = x

    def observe_many(self, xs) -> None:
        """Record a batch of samples under ONE lock acquisition -- the
        batcher worker records a whole batch's queue waits this way, so
        per-request cost amortises to a bisect plus a few adds.  The sum
        adds the samples one by one, as ``observe`` would (the built-in
        ``sum`` of floats rounds differently from Python 3.12 on)."""
        if not self._registry.enabled:
            return
        xs = [float(x) for x in xs]
        if not xs:
            return
        idx = [bisect_left(_HIST_BOUNDS, x) for x in xs]
        with self._lock:
            for i in idx:
                self._counts[i] += 1
            self._n += len(xs)
            total = self._sum
            for x in xs:
                total += x
            self._sum = total
            lo, hi = min(xs), max(xs)
            if lo < self._min:
                self._min = lo
            if hi > self._max:
                self._max = hi

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-th sample (q in
        [0, 1]); NaN on an empty histogram.  q = 0 maps to the first
        sample, q = 1 to the last."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self._n == 0:
                return math.nan
            # rank of the q-th sample, 1-based (ceil, min 1): the sample
            # below which a fraction q of the distribution sits
            rank = max(1, math.ceil(q * self._n))
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= rank:
                    return (_HIST_BOUNDS[i] if i < _HIST_BUCKETS
                            else math.inf)
            return math.inf               # pragma: no cover - unreachable

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> dict:
        """count/sum/min/max/mean + p50/p90/p99/p999, one lock
        acquisition.  p999 is the tail the slow log keys off: a
        ``slow_threshold_s`` near the steady p999 captures the genuine
        outliers instead of half the traffic."""
        with self._lock:
            n, total = self._n, self._sum
            counts = list(self._counts)
            lo, hi = self._min, self._max
        out = {"count": n, "sum": total,
               "min": (None if n == 0 else lo),
               "max": (None if n == 0 else hi),
               "mean": (None if n == 0 else total / n)}
        for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99"),
                       (0.999, "p999")):
            if n == 0:
                out[key] = None
                continue
            rank = max(1, math.ceil(q * n))
            seen = 0
            for i, c in enumerate(counts):
                seen += c
                if seen >= rank:
                    out[key] = (_HIST_BOUNDS[i] if i < _HIST_BUCKETS
                                else math.inf)
                    break
        return out


class MetricsRegistry:
    """One process-wide (or per-test) home for every instrument.

    ``counter``/``gauge``/``histogram`` get-or-create by (name, labels):
    the same series object comes back every time, so call sites may
    either cache the instrument (hot paths do) or look it up ad hoc.
    ``enabled`` flips all recording on/off without touching call sites.
    ``timeline`` is the serving path's span ring
    (:class:`~repro_torch.obs.tracing.Timeline`), recording only while a
    ``torch.profiler`` session records.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple, _Instrument] = {}
        self.timeline = Timeline(self)

    def _get(self, cls, name: str, labels: dict) -> _Instrument:
        key = (cls.__name__, name, _labels_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = self._instruments[key] = cls(name, key[2], self)
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def value(self, name: str, default=0, **labels):
        """Current value of a counter/gauge series WITHOUT creating it
        (stats snapshots read series that may never have fired)."""
        for kind in ("Counter", "Gauge"):
            inst = self._instruments.get((kind, name, _labels_key(labels)))
            if inst is not None:
                return inst.value
        return default

    def series(self, name: str) -> dict:
        """Every counter/gauge series recorded under ``name``, keyed by
        its "k=v,k=v" label string ("" for the unlabelled series) -- the
        per-group breakdown the stats snapshots render (e.g. merges
        applied per replica group)."""
        out = {}
        with self._lock:
            items = list(self._instruments.items())
        for (kind, n, labels), inst in items:
            if n == name and kind in ("Counter", "Gauge"):
                out[",".join(f"{k}={v}" for k, v in labels)] = inst.value
        return out

    def total(self, name: str, default=0):
        """Sum of a counter's value across ALL label series (the
        cluster-level reconciliation helper: queries issued must equal
        the sum of per-group completed counts)."""
        out, seen = default, False
        for (kind, n, _), inst in list(self._instruments.items()):
            if kind == "Counter" and n == name:
                out = (0 if not seen else out) + inst.value
                seen = True
        return out

    def snapshot(self) -> dict:
        """{"counters": {name: {label_str: value}}, "gauges": {...},
        "histograms": {name: {label_str: {count,sum,min,max,mean,pXX}}}}
        -- label_str is "k=v,k=v" ("" for unlabelled series) -- and,
        while the timeline holds spans, "timeline":
        :meth:`~repro_torch.obs.tracing.Timeline.snapshot`."""
        with self._lock:
            items = list(self._instruments.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        section = {"Counter": "counters", "Gauge": "gauges",
                   "Histogram": "histograms"}
        for (kind, name, labels), inst in items:
            label_str = ",".join(f"{k}={v}" for k, v in labels)
            val = (inst.snapshot() if kind == "Histogram" else inst.value)
            out[section[kind]].setdefault(name, {})[label_str] = val
        timeline = self.timeline.snapshot()
        if timeline is not None:
            out["timeline"] = timeline
        return out


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry components fall back to when no
    explicit one is injected (tests inject their own for isolation)."""
    return _DEFAULT
