"""The least time of a batch's phase 1 on the ``postings`` engine: the
least of the walk's bound and the scan's.

The walk's bound is a frozen copy of the port's ``postings_work``
(``src/repro_torch/obs/cost.py`` as of this file): each posting entry
walked reads its int32 doc id and reads and writes its float32
accumulator cell, 12 bytes, and the dense (Q, d) float32 accumulator is
filled once and read once by the page selection, at the H100's HBM rate.
The scan's bound is ``fused_phase1``'s frozen bound at the cell's
shapes, the same page by scoring every row.  Taking the least makes the
share read the same work whatever implements phase 1.
"""

from __future__ import annotations

from .share import launch_work
from .work import HBM_BYTES_PER_S, bound_s

ENTRY_BYTES = 12           # doc id read, accumulator read and written


def walk_bytes(entries: float, Q: int, d: int) -> float:
    """Least bytes of one batch's walk of ``entries`` posting entries into
    a (Q, d) float32 accumulator."""
    return entries * ENTRY_BYTES + 2 * Q * d * 4


def walk_bound_s(entries: float, Q: int, d: int) -> float:
    return walk_bytes(entries, Q, d) / HBM_BYTES_PER_S


def least_phase1_s(config: dict, entries: float) -> float:
    """The least seconds of one batch's phase 1 at the configuration's
    shapes, with ``entries`` posting entries to walk."""
    Q = int(config["batcher"]["batch_size"])
    d = int(config["corpus"]["docs"])
    scan, _ = bound_s(launch_work(config, "fused_phase1"))
    return min(walk_bound_s(entries, Q, d), scan)
