"""CUDA graphs of the batcher's search: a batch's search issued as one
replay of a graph captured once for each served index instance.

A batch's search on a fused engine is a chain of small kernels: at 4
doc-shards with an active buffer about two hundred launches (encode, two
``fused_phase1_quant`` calls a shard, page joins, gathers, exact
cosines, the merge and the rescore), each through PyTorch's eager
dispatch, from a batcher thread that shares the interpreter with the
other batchers and the clients.  Nothing in the chain needs the host
between the queries' copy in and the answers' copy out, and the batcher
pads every batch to one shape, so the chain is the same for every batch
one index instance serves.  :class:`SearchGraphs` captures it once and
replays it: the kernels, their order and their arithmetic are those of
the eager search, so the answers are bit for bit the same.

**When it engages** (:meth:`SearchGraphs.engages`): the engine is one of
:data:`repro_torch.core.search.FUSED_ENGINES`, whose search has no
synchronisation, the served index's tensors are on a CUDA device, and
no request of the batch asked for a profile (the engine's check).  Every
other batch runs eagerly: CPU indexes, the composed engines, profiled
batches.  On an index instance that engages,

* the first batch runs eagerly, and so fills the instance's lazy caches
  (the int8 tables) outside any capture;
* the second captures the search into a graph and is answered by the
  graph's first replay;
* every later batch writes its queries into the graph's pinned input
  and replays it; the graph copies them to the card first.

A capture that raises leaves that instance eager for good, and the next
instance's capture takes a new memory pool.  No capture begins while a
``torch.profiler`` session records: the session's end synchronises the
device, which CUDA forbids while any stream captures, so a batch due to
capture then runs eagerly and a later one captures once the session has
ended (instances made before the session replay through it).

**Key and lifetime.**  The entry holds the index object itself,
strongly; an engine keeps one entry.  Nothing else needs a key: the
engine's search arguments (``k``, ``page``, ``trim``, ``engine``,
``merge``, ``max_postings``) are fixed when it is made, and it pads
every batch to its ``batch_size``, so each batch it serves from one
index is the same search.  A graph freezes the Python values of its
capture (a shard's page, the generation count, which tables exist), so
an index is never replayed but by the graph of that very object.  Every
mutation (an add, a delete, a merge, a swap) hands the engine a new
object, whose first batch then replaces the entry.  Each capture shares
the memory pool of the engine's previous graph, which is never replayed
again, so an engine holds about one graph's memory at a time.  The pool
is outside :func:`repro_torch.obs.device.device_bytes`'s index leaves.

**Capture safety.**  A capture runs under a process-wide lock, one at a
time, with ``capture_error_mode="thread_local"``: the other batchers
keep serving, eagerly or by replay, meanwhile.  It calls
``CUDAGraph.capture_begin`` / ``capture_end`` itself, because
``torch.cuda.graph``'s entry synchronises the device and empties the
allocator's cache, which would stall the other batchers at every
capture.  Each engine captures on a side stream of its own: the graph's
copy uses the pinned input on that stream, so the host allocator records
an event there when the input is freed (on the engine's thread, between
its captures), and that event must not land in another batcher's
capture.  A wrapper whose ``search`` decides on the host at each call
gives that decision as ``replay_guard()``, entered around each replay
(the cluster router's failpoint).

**Bookkeeping.**  The kernel wrappers' cost rows and launch counts made
while capturing go to a :class:`repro_torch.obs.cost.Tape`, filed once
for the capture's own batch and again for each replay, so a replayed
batch counts what its eager twin counts.  The counters
``engine.graph.captures``, ``.replays``, ``.eager`` (labelled ``group``
under a router) add one a batch, to exactly one of the three:
``replays / (captures + replays + eager)`` is the share of batches a
replay answered.  ``engine.graph.failed`` counts the captures that
raised, the last one's error kept as ``SearchGraphs.last_failure``;
their batches ran eagerly and count under ``eager``.  The histogram
``engine.graph.capture.latency_s`` times each capture that succeeded,
from the lock's taking to the graph's instantiation.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from torch.autograd import profiler as _autograd_profiler

from repro_torch.core.search import FUSED_ENGINES
from repro_torch.obs import cost
from repro_torch.obs.tracing import phase_clock

__all__ = ["SearchGraphs", "CudaGraphBackend"]

# one capture at a time in the process (CUDA's rule for the allocator's
# capture pools)
_CAPTURE_LOCK = threading.Lock()


class CudaGraphBackend:
    """One engine's captures on the card.  ``capture(fn, device, share)``
    records ``fn()``'s work into a ``torch.cuda.CUDAGraph`` without
    running it, on this backend's side stream and in the memory pool of
    graph ``share`` (None: a new pool) -> (graph, ``fn``'s outputs, which
    each replay overwrites); ``replay(graph)`` runs it on the current
    stream."""

    def __init__(self):
        self._stream: Optional["torch.cuda.Stream"] = None

    def engages(self, device) -> bool:
        return device is not None and torch.device(device).type == "cuda"

    def capture(self, fn: Callable, device, share=None):
        device = torch.device(device)
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._stream):
            graph.capture_begin(
                pool=None if share is None else share.pool(),
                capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
        return graph, out

    def replay(self, graph) -> None:
        graph.replay()


class _Entry:
    """One index instance's state: seen once (``graph`` None), captured,
    or ``failed``."""

    __slots__ = ("index", "graph", "buffers", "host", "out", "tape",
                 "failed")

    def __init__(self, index):
        self.index = index
        self.graph = self.buffers = self.host = self.out = self.tape = None
        self.failed = False


class SearchGraphs:
    """One engine's graph of its batch search (module docstring).  Used
    by the engine's worker thread alone.  ``backend`` captures and
    replays (a test on the CPU sets its own before the first batch);
    ``labels`` label the counters."""

    def __init__(self, metrics, **labels):
        self.backend = CudaGraphBackend()
        self._c_captures = metrics.counter("engine.graph.captures", **labels)
        self._c_replays = metrics.counter("engine.graph.replays", **labels)
        self._c_eager = metrics.counter("engine.graph.eager", **labels)
        self._c_failed = metrics.counter("engine.graph.failed", **labels)
        self._h_capture = metrics.histogram("engine.graph.capture.latency_s",
                                            **labels)
        self._entry: Optional[_Entry] = None
        self._last = None       # the newest graph: the next capture's pool
        self.last_failure: Optional[str] = None   # the last capture's error

    def engages(self, index, engine: str) -> bool:
        return (engine in FUSED_ENGINES
                and self.backend.engages(getattr(index, "device", None)))

    def search(self, index, qs: np.ndarray, search: Callable,
               graph: bool = True):
        """``search(queries)`` of the batch's padded queries ``qs`` ->
        (ids, scores) on the index's device, eagerly where ``graph`` is
        false, else by ``index``'s graph where this engine has one (valid
        until this engine's next batch)."""
        e = self._entry
        if not graph or e is None or e.index is not index:
            if graph:
                self._entry = None          # the old graph's outputs go
            self._c_eager.inc()
            out = search(torch.from_numpy(qs))
            if graph:
                self._entry = _Entry(index)
            return out
        if e.graph is None and not (
                e.failed or _autograd_profiler._is_profiler_enabled):
            return self._capture(e, qs, search)
        if e.graph is None:
            self._c_eager.inc()
            return search(torch.from_numpy(qs))
        guard = getattr(index, "replay_guard", None)
        with guard() if guard is not None else contextlib.nullcontext():
            self._replay(e, qs)
        self._c_replays.inc()
        return e.out

    def _replay(self, e: _Entry, qs: np.ndarray) -> None:
        """The batch's queries into the graph's pinned input (the last
        batch's answers were copied out before this batch began, so it is
        free), the replay, which copies them to the card first, and the
        capture's bookkeeping filed again.  Between the batch's queries
        and its answers' copies the batcher lets the interpreter lock go
        once, in the replay's launch: a batcher that lets it go may wait a
        switch interval (5 ms) to take it back from the other batchers and
        the clients.  So the input is written through a memoryview, whose
        copy keeps the lock (numpy's lets it go above 500 elements), and
        the copy to the card is the graph's."""
        clock = phase_clock()
        e.host[:] = memoryview(np.ascontiguousarray(qs, np.float32)).cast(
            "B")
        self.backend.replay(e.graph)
        if clock is not None:
            clock.close("search.replay")
        e.tape.replay()

    def _capture(self, e: _Entry, qs: np.ndarray, search: Callable):
        device = torch.device(e.index.device)
        host = torch.empty(qs.shape, dtype=torch.float32,
                           pin_memory=device.type == "cuda")
        queries = torch.empty(qs.shape, dtype=torch.float32, device=device)

        def load_and_search():
            queries.copy_(host, non_blocking=True)
            return search(queries)

        tape = cost.Tape()
        try:
            with _CAPTURE_LOCK, tape:
                t0 = time.monotonic()
                graph, out = self.backend.capture(load_and_search, device,
                                                  self._last)
                took = time.monotonic() - t0
        except Exception as exc:  # noqa: BLE001 - any refusal leaves it eager
            e.failed = True
            self.last_failure = repr(exc)
            # a capture that failed may leave the allocator recording into
            # the pool it was given: the next capture takes a new one
            self._last = None
            self._c_failed.inc()
            self._c_eager.inc()
            return search(torch.from_numpy(qs))
        # the graph reads and writes these buffers by address: the entry
        # keeps them, with the index, for as long as it keeps the graph
        e.buffers = (host, queries)
        e.host = memoryview(host.numpy()).cast(  # host-seam: a view, no copy
            "B")
        e.graph, e.out, e.tape = graph, out, tape
        self._last = graph
        self._replay(e, qs)
        self._c_captures.inc()
        self._h_capture.observe(took)
        return out

    def close(self) -> None:
        """Let the entry and its graph go (the engine has stopped)."""
        self._entry = self._last = None
