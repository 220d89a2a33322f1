"""The measured window: an open loop of queries due on a schedule, or a
closed loop of sessions that each send their next query the moment the
last is answered, and, where the mix has one, a writer of bulks on a
fixed schedule.  Every time is the host's monotonic clock; the trace's
clock (``time.time_ns``) is kept beside the window's edges and the
benchmark's own spans."""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np


class Recorder:
    """Per-query records, preallocated: due, sent and done times, the
    answer, the bulks acknowledged when it was sent (``n_req``) and begun
    when it was answered (``n_pos``): a query must see the first and may
    see the second, as it is served on the index of its batch."""

    def __init__(self, n: int, k: int, writer=None):
        self.n = n
        self.due = np.full(n, np.nan)
        self.sent = np.full(n, np.nan)
        self.done = np.full(n, np.nan)
        self.ok = np.zeros(n, bool)
        self.failed = np.zeros(n, bool)
        self.ids = np.full((n, k), -1, np.int64)
        self.scores = np.full((n, k), np.nan, np.float32)
        self.n_req = np.zeros(n, np.int64)
        self.n_pos = np.zeros(n, np.int64)
        self.count = 0               # queries sent
        self.writer = writer

    def callback(self, i: int, then=None):
        def done(fut):
            t = time.monotonic()
            self.done[i] = t
            if self.writer is not None:
                self.n_pos[i] = self.writer.begun
            try:
                ids, scores = fut.result()[:2]
            except Exception:        # noqa: BLE001 - a failed query
                self.failed[i] = True
            else:
                self.ids[i] = ids
                self.scores[i] = scores
                self.ok[i] = True
            if then is not None:
                then(t)
        return done


class Writer:
    """Calls ``add`` with bulk j at ``t0 + offsets[j]``, one at a time, on
    a thread of its own; counts bulks begun and acknowledged."""

    def __init__(self, add, bulks: List[np.ndarray], offsets: np.ndarray,
                 spans: Optional[list]):
        self.add, self.bulks, self.offsets = add, bulks, offsets
        self.spans = spans
        self.begun = 0
        self.acked = 0
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self, t0: float) -> None:
        self._thread = threading.Thread(target=self._run, args=(t0,),
                                        daemon=True)
        self._thread.start()

    def _run(self, t0: float) -> None:
        try:
            for j, off in enumerate(self.offsets):
                wait = t0 + off - time.monotonic()
                if self._stop.wait(max(wait, 0.0)):
                    return
                ns0 = time.time_ns()
                self.begun = j + 1
                self.add(self.bulks[j])
                self.acked = j + 1
                if self.spans is not None:
                    self.spans.append(("ingest.add_documents", ns0,
                                       time.time_ns()))
        except BaseException as exc:  # noqa: BLE001 - reported by join
            self.error = exc

    def join(self, timeout: float) -> None:
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("the writer did not finish its bulk")
        if self.error is not None:
            raise self.error


class Senders:
    """Client threads that make the sends.  ``post(i, stream)`` hands
    query ``i`` over, or, with ``i=None``, asks for the run's next query
    (a closed loop's session); one of ``threads`` client threads records
    its send time, submits it and hangs the recorder's callback on its
    future.  So the scheduler keeps its clock while a submit waits, and a
    completion callback, which runs on the server's own thread, does no
    client work there: it only posts."""

    def __init__(self, system, rec: Recorder, queries: np.ndarray,
                 threads: int, writer: Optional[Writer] = None,
                 spans: Optional[list] = None, then=None):
        self.system, self.rec, self.queries = system, rec, queries
        self.writer, self.spans, self.then = writer, spans, then
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(max(1, int(threads)))]
        for t in self._threads:
            t.start()

    def post(self, i: Optional[int], stream: int) -> None:
        self._q.put((i, stream))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            self._send(*item)

    def _send(self, i: Optional[int], stream: int) -> None:
        rec = self.rec
        if i is None:
            with self._lock:
                i = rec.count
                if i >= rec.n:
                    return
                rec.count = i + 1
            rec.due[i] = time.monotonic()
        if self.writer is not None:
            rec.n_req[i] = self.writer.acked
        ns0 = time.time_ns() if self.spans is not None else 0
        rec.sent[i] = time.monotonic()
        try:
            fut = self.system.submit(self.queries[i], int(stream))
        except RuntimeError:
            rec.failed[i] = True
            rec.done[i] = rec.sent[i]
            return
        then = (None if self.then is None
                else (lambda t, s=stream: self.then(s, t)))
        fut.add_done_callback(rec.callback(i, then))
        if self.spans is not None:
            self.spans.append(("client.submit", ns0, time.time_ns()))

    def close(self, timeout: float) -> None:
        """Stop the client threads once every posted send is made."""
        for _ in self._threads:
            self._q.put(None)
        end = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, end - time.monotonic()))
            if t.is_alive():
                raise RuntimeError("a client thread did not finish")


def open_loop(senders: Senders, rec: Recorder, offsets: np.ndarray,
              streams: np.ndarray, t0: float) -> None:
    """Hand query i to the client threads at ``t0 + offsets[i]`` (its
    lag is ``sent - due``)."""
    for i, off in enumerate(offsets):
        due = t0 + off
        wait = due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        rec.due[i] = due
        senders.post(i, int(streams[i]))
        rec.count = i + 1


class ClosedLoop:
    """``sessions`` clients, each pinned by its stream id; a session
    posts its next query from the completion of its last, until the window
    closes.  Query j of the run is ``queries[j]``, due when it is sent."""

    def __init__(self, system, rec: Recorder, queries: np.ndarray,
                 sessions: int, threads: int,
                 writer: Optional[Writer] = None,
                 spans: Optional[list] = None):
        self.sessions = sessions
        self.t_close = float("inf")
        self.senders = Senders(system, rec, queries, threads, writer,
                               spans, then=self._next)

    def _next(self, s: int, t: float) -> None:
        if t < self.t_close:
            self.senders.post(None, s)

    def start(self, t0: float, seconds: float) -> None:
        self.t_close = t0 + seconds
        for s in range(self.sessions):
            self.senders.post(None, s)


def wait_answers(rec: Recorder, timeout: float) -> None:
    """Wait until every sent query has an answer or a failure, at most
    ``timeout`` seconds."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        n = rec.count
        if np.all(rec.ok[:n] | rec.failed[:n]):
            return
        time.sleep(0.01)
