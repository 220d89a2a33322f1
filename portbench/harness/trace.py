"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
window, reduced to device intervals (every kernel, copy and set the
card ran, from any thread), the busy union, the longest idle gaps named
by the benchmark span the host was in, and device time by operation."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np


class DeviceTrace:
    """Device operations clipped to the window ``[w0, w1]`` (ns, the
    profiler's clock, which is the wall clock of ``time.time_ns``)."""

    def __init__(self, ops: List[Tuple[str, int, int]], w0: int, w1: int,
                 spans: List[Tuple[str, int, int]]):
        self.w0, self.w1 = w0, w1
        self.whole = [o for o in ops if o[1] >= w0 and o[2] <= w1]
        self.ops = [(n, max(a, w0), min(b, w1)) for n, a, b in ops
                    if b > w0 and a < w1]
        self.spans = spans

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def op_seconds(self, pattern: str = "", whole: bool = False
                   ) -> Tuple[float, int]:
        """(device seconds, launches) of the operations whose name
        contains ``pattern``: clipped to the window, or only those wholly
        inside it (``whole``)."""
        ops = self.whole if whole else self.ops
        sel = [b - a for n, a, b in ops if pattern in n]
        return sum(sel) * 1e-9, len(sel)

    def top_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, int] = {}
        for name, a, b in self.ops:
            tot[name] = tot.get(name, 0) + (b - a)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest gaps between device operations in the window,
        each named by the benchmark span that covered its middle
        (``"host: no benchmark span"`` where none did)."""
        busy = self.busy_intervals()
        edges = [self.w0] + [x for iv in busy for x in iv] + [self.w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        if self.spans:
            starts = np.array([s[1] for s in self.spans])
            order = np.argsort(starts)
            starts = starts[order]
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) // 2
            name = "host: no benchmark span"
            if self.spans:
                j = int(np.searchsorted(starts, mid, side="right")) - 1
                # the latest span begun before the middle that covers it
                for jj in range(j, max(j - 64, -1), -1):
                    s = self.spans[order[jj]]
                    if s[2] >= mid:
                        name = s[0]
                        break
            out.append([name, (b - a) * 1e-9])
        return out


@contextlib.contextmanager
def profiled(enabled: bool):
    """``torch.profiler`` over the block when ``enabled``; yields a holder
    whose ``ops`` are the device operations as ``(name, start_ns,
    end_ns)`` once the block has closed.  On a card it records the CUDA
    activity alone: recording every host-side operator as well slowed
    the ingest cell's host enough to fall behind its offered rate."""
    holder = _Holder()
    if not enabled:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
            else [ProfilerActivity.CPU])
    with profile(activities=acts) as prof:
        yield holder
    holder.ops = _device_ops(prof)


class _Holder:
    ops: Optional[List[Tuple[str, int, int]]] = None


def _device_ops(prof) -> List[Tuple[str, int, int]]:
    out = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        a = int(e.start_ns())
        out.append((e.name(), a, a + int(e.duration_ns())))
    return out
