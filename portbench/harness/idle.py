"""What the host was doing while the card sat idle: the traced window's
idle time split by the program's timeline (``registry.timeline``, the
``timeline`` section of the registry's snapshot at the window's end)
and the collector's pauses.

Each idle instant of the window ``[w0, w1]`` (outside the busy union of
:class:`~.trace.DeviceTrace`) goes to the first of these that covers it:

1. ``collector``: a run of the cyclic garbage collector;
2. ``ingest``: any ``ingest.add`` span;
3. ``merge``: any ``maintenance.merge`` span;
4. ``host``: any batcher thread in ``batcher.form``, ``search.launch``,
   ``search.answer_wait`` or ``batcher.deliver``;
5. ``starved``: every batcher thread in ``batcher.wait``;
6. ``unattributed``: the rest.

The six tile the idle time.  Spans are on ``time.monotonic_ns`` and the
collector's pauses on ``time.monotonic``; the snapshot's anchor pair maps
both onto the trace's clock (``time.time_ns``).  A program without the
timeline (no ``timeline`` section) gives ``None`` for every share."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

SHARES = ("collector", "ingest", "merge", "host", "starved",
          "unattributed")
HOST_SPANS = ("batcher.form", "search.launch", "search.answer_wait",
              "batcher.deliver")
BATCHER_SPANS = HOST_SPANS + ("batcher.wait",)


def timeline(run) -> Optional[dict]:
    """The program's timeline at the window's end, or None (a program
    without one, or an untraced run)."""
    return run.counters1.get("timeline")


def _covered(t0: np.ndarray, t1: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Whether each point ``x`` lies in some ``[t0, t1)``: the latest end
    among the intervals begun by ``x`` passes it."""
    if t0.size == 0:
        return np.zeros(x.shape, bool)
    order = np.argsort(t0, kind="stable")
    starts = t0[order]
    reach = np.maximum.accumulate(t1[order])
    j = np.searchsorted(starts, x, side="right") - 1
    return (j >= 0) & (reach[np.maximum(j, 0)] > x)


def _pairs(intervals, off: int = 0):
    iv = np.asarray(intervals, np.int64).reshape(-1, 2) + off
    return iv[:, 0], iv[:, 1]


def attribute(w0: int, w1: int, busy, gc_ns, tl: dict) -> Dict[str, int]:
    """Nanoseconds of the window's idle time by :data:`SHARES`, with
    ``idle`` and ``window``.  ``w0``, ``w1`` and the ``busy`` ``(start,
    end)`` pairs are on the trace's clock, the collector's ``gc_ns``
    pairs on ``time.monotonic_ns``; ``tl`` is a timeline snapshot."""
    off = int(tl["anchor"]["wall_ns"]) - int(tl["anchor"]["monotonic_ns"])
    sp = tl["spans"]
    names = np.asarray(tl["names"])[sp["name"]]
    a = sp["t0_ns"].astype(np.int64) + off
    b = sp["t1_ns"].astype(np.int64) + off
    sets = {"busy": _pairs(busy), "collector": _pairs(gc_ns, off)}
    for key, pick in (("ingest", ("ingest.add",)),
                      ("merge", ("maintenance.merge",)),
                      ("host", HOST_SPANS)):
        sel = np.isin(names, pick)
        sets[key] = (a[sel], b[sel])
    threads = np.unique(sp["thread"][np.isin(names, BATCHER_SPANS)])
    waits = [(a[sel], b[sel]) for sel in
             ((names == "batcher.wait") & (sp["thread"] == t)
              for t in threads)]
    ends = [np.array([w0, w1], np.int64)]
    ends += [np.concatenate(iv) for iv in list(sets.values()) + waits]
    edges = np.unique(np.clip(np.concatenate(ends), w0, w1))
    # every edge is in `edges`: a segment lies wholly in or out of a set
    x, length = edges[:-1], np.diff(edges)
    left = ~_covered(*sets["busy"], x)
    out = {"window": w1 - w0, "idle": int(length[left].sum())}
    for key in ("collector", "ingest", "merge", "host"):
        hit = left & _covered(*sets[key], x)
        out[key] = int(length[hit].sum())
        left &= ~hit
    starved = np.full(x.shape, threads.size > 0)
    for iv in waits:
        starved &= _covered(*iv, x)
    out["starved"] = int(length[left & starved].sum())
    out["unattributed"] = int(length[left & ~starved].sum())
    return out


def shares(run) -> Optional[Dict[str, float]]:
    """Percent of the traced window by :data:`SHARES` (and ``idle``),
    computed once a run; None untraced or without the timeline."""
    if run.trace is None or timeline(run) is None:
        return None
    got = getattr(run, "_idle_shares", None)
    if got is None:
        tr = run.trace
        ns = attribute(tr.w0, tr.w1, tr.busy_intervals(),
                       [(round(p[1] * 1e9), round(p[2] * 1e9))
                        for p in run.gc_pauses], timeline(run))
        got = {k: 100.0 * v / ns["window"] for k, v in ns.items()
               if k != "window"}
        run._idle_shares = got
    return got


def share(run, key: str) -> Optional[float]:
    got = shares(run)
    return None if got is None else got[key]


def mean_span_ms(run, name: str) -> Optional[float]:
    """Mean duration of the ``name`` spans begun in the window (0.0 with
    none); None without the timeline."""
    tl = timeline(run)
    if tl is None:
        return None
    sp = tl["spans"]
    sel = ((sp["name"] == tl["names"].index(name))
           & (sp["t0_ns"] >= round(run.t0 * 1e9))
           & (sp["t0_ns"] < round(run.t_close * 1e9)))
    if not sel.any():
        return 0.0
    return float((sp["t1_ns"][sel] - sp["t0_ns"][sel]).mean()) * 1e-6
