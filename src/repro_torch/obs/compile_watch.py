"""Build telemetry: count and attribute kernel builds per call site.

The port's counterpart of a recompile is an ``nvcc`` build: each
hand-written kernel library is compiled at its first launch in a process
(:func:`repro_torch.kernels._build.load_library`), which stalls the
request that triggered it for seconds.  This module makes such stalls
observable with ES hot-threads-style attribution:

* the serving path's dispatch, ingest and delete run inside a cheap
  :func:`watch_region` (a thread-local push/pop);
* one process-wide listener in ``_build.build_listeners`` receives each
  build's wall seconds and attributes them to the innermost region
  active ON THE CALLING THREAD (a library is built synchronously inside
  the launching call, so the region on top of the stack is the culprit);
  builds outside any region land in an ``<unattributed>`` bucket.
  Loading a library that is already built is not a build;
* a :class:`CompileWatch` counts builds per (region, signature), records
  build wall time into the ``compile.duration_s`` histogram, and --
  after :meth:`~CompileWatch.mark_steady` -- treats any further
  region-attributed build as a steady-state build:
  ``compiles_steady_state`` in stats, and a hard error from
  :meth:`~CompileWatch.check`.

The ``sig`` a region carries is the shape signature of the dispatch
(batch shape, dtype, engine, static config).  Names, schema and
counters are the JAX package's, where the event is an XLA compile.

Regions nest and attribution always goes to the innermost -- each build
is counted exactly once.  ``<unattributed>`` builds (a warm-up that
builds every library up front, test scaffolding) never count against the
steady state: the watch guards the serving paths that were wrapped, not
the whole process.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from repro_torch.kernels import _build

__all__ = ["CompileWatch", "active_watch", "watch_region"]

_UNATTRIBUTED = "<unattributed>"

_TLS = threading.local()            # .stack: [(watch, region, sig), ...]
_install_lock = threading.Lock()
_installed = False
_default: "Optional[CompileWatch]" = None
_default_lock = threading.Lock()


def _on_build(name: str, seconds: float) -> None:
    stack = getattr(_TLS, "stack", None)
    if stack:
        watch, region, sig = stack[-1]
    else:
        watch, region, sig = active_watch(), _UNATTRIBUTED, ()
    watch._record(region, sig, seconds)


def _ensure_listener() -> None:
    """Register the (one, process-wide) build listener: a single
    dispatcher routes builds to whichever watch owns the active region."""
    global _installed
    if _installed:
        return
    with _install_lock:
        if _installed:
            return
        _build.build_listeners.append(_on_build)
        _installed = True


class _Region:
    __slots__ = ("watch", "name", "sig")

    def __init__(self, watch: "CompileWatch", name: str, sig: Tuple):
        self.watch, self.name, self.sig = watch, name, sig

    def __enter__(self):
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        stack.append((self.watch, self.name, self.sig))
        return self

    def __exit__(self, *exc):
        _TLS.stack.pop()
        return False


class CompileWatch:
    """Per-(region, signature) build counters + steady-state guard.

    ``metrics`` (default: the process registry) receives
    ``compile.total`` / ``compile.steady_state`` counters and the
    ``compile.duration_s`` histogram, all labelled ``fn=<region>``, so
    ``stats()`` rollups and the Prometheus exporter see builds next to
    the latencies they perturb.
    """

    def __init__(self, metrics=None):
        from .metrics import default_registry

        self.metrics = metrics if metrics is not None else default_registry()
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, Tuple], int] = {}
        self._steady = False
        self._steady_events: List[dict] = []
        self._total = 0
        self._steady_total = 0
        _ensure_listener()

    # -------------------------------------------------------------- regions
    def region(self, name: str, sig=()):
        """Context manager attributing any build inside to ``name`` with
        shape signature ``sig`` (a small hashable tuple).  Cost when
        nothing builds: a thread-local append/pop."""
        return _Region(self, name, tuple(sig))

    # ------------------------------------------------------------ recording
    def _record(self, region: str, sig: Tuple, duration: float) -> None:
        with self._lock:
            key = (region, sig)
            repeat = key in self._counts
            self._counts[key] = self._counts.get(key, 0) + 1
            self._total += 1
            # steady-state violations are REGION builds only: the watch
            # guards the wrapped serving paths, not unrelated host code
            steady = self._steady and region != _UNATTRIBUTED
            if steady:
                self._steady_total += 1
                self._steady_events.append({
                    "fn": region,
                    "sig": [str(s) for s in sig],
                    "duration_s": float(duration),
                    "repeat_sig": repeat,
                })
        self.metrics.histogram("compile.duration_s", fn=region).observe(
            duration)
        self.metrics.counter("compile.total", fn=region).inc()
        if steady:
            self.metrics.counter("compile.steady_state", fn=region).inc()

    # ----------------------------------------------------------- steadiness
    def mark_steady(self) -> None:
        """Declare warmup over: every region-attributed build after this
        point is an unexpected steady-state build."""
        with self._lock:
            self._steady = True

    def check(self) -> None:
        """Raise ``RuntimeError`` listing every steady-state build (the
        JAX package's message, "steady-state recompile"); no-op when
        clean."""
        with self._lock:
            events = list(self._steady_events)
        if events:
            detail = "; ".join(
                f"{e['fn']}(sig={','.join(e['sig']) or '-'}"
                f"{', repeat' if e['repeat_sig'] else ''})"
                for e in events)
            raise RuntimeError(
                f"{len(events)} steady-state recompile(s): {detail}")

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._steady_events.clear()
            self._steady = False
            self._total = 0
            self._steady_total = 0

    # ---------------------------------------------------------------- stats
    @property
    def compiles_total(self) -> int:
        with self._lock:
            return self._total

    @property
    def compiles_steady_state(self) -> int:
        with self._lock:
            return self._steady_total

    def stats(self) -> dict:
        """The stats-section dict: totals, per-function build counts,
        distinct signatures seen, and any steady-state events."""
        with self._lock:
            by_fn: Dict[str, int] = {}
            for (region, _sig), c in self._counts.items():
                by_fn[region] = by_fn.get(region, 0) + c
            return {
                "compiles_total": self._total,
                "compiles_steady_state": self._steady_total,
                "steady": self._steady,
                "signatures": len(self._counts),
                "by_function": by_fn,
                "steady_events": list(self._steady_events),
            }


def active_watch() -> CompileWatch:
    """The process-default watch (what engines share when none is
    injected -- the :func:`repro_torch.obs.metrics.default_registry`
    pattern)."""
    global _default
    if _default is None:
        w = CompileWatch()
        with _default_lock:
            if _default is None:
                _default = w
    return _default


def watch_region(name: str, sig=()):
    """A region on whichever watch is already active on this thread
    (else the process default) -- how an inner seam inherits the
    engine's watch without threading a reference through every call."""
    stack = getattr(_TLS, "stack", None)
    watch = stack[-1][0] if stack else active_watch()
    return watch.region(name, sig)
