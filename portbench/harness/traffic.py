"""Traffic from a mix file's parameters: when queries are due, which rows
they copy, which session sends them, and when the writer writes.

Every seed gets the same set of inter-arrival gaps, in another order: the
gaps are the exponential distribution's quantiles at ``(i + 1/2) / n``,
shuffled by the seed.  So each run offers exactly ``n = rate * seconds``
queries with Poisson-like spacing, and runs differ in order, not in load.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


def host_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use (``stream``) of the seed."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, stream])


def poisson_gaps(rate: float, seconds: float) -> np.ndarray:
    """The ``round(rate * seconds)`` gaps every seed shares: the
    exponential distribution's quantiles at ``(i + 1/2) / n``."""
    n = max(1, int(round(rate * seconds)))
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def poisson_offsets(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of ``round(rate * seconds)``
    queries: the first at 0, then the shared gaps in the seed's order."""
    gaps = poisson_gaps(rate, seconds)
    host_rng(seed, 1).shuffle(gaps)
    return np.cumsum(gaps) - gaps


def write_offsets(period_s: float, start_s: float, seconds: float
                  ) -> np.ndarray:
    """Due times of the writer's bulks inside the window."""
    if period_s <= 0:
        return np.zeros(0)
    n = int(math.floor((seconds - start_s) / period_s)) + 1
    return start_s + period_s * np.arange(max(n, 0))


@dataclasses.dataclass
class QueryPlan:
    """Which row each query copies: ``src`` indexes the base rows, or,
    where ``bulk >= 0``, row ``src`` of appended bulk ``bulk``; ``stream``
    is the session that sends it (-1: none)."""

    src: np.ndarray
    bulk: np.ndarray
    stream: np.ndarray


def plan_queries(n: int, n_base: int, seed: int, streams: int,
                 due: Optional[np.ndarray] = None,
                 bulk_due: Optional[np.ndarray] = None, bulk_rows: int = 0,
                 appended_share: float = 0.0, lag_s: float = 0.5
                 ) -> QueryPlan:
    """``n`` queries: each copies a uniformly drawn base row or, with
    probability ``appended_share`` and where some bulk was due at least
    ``lag_s`` before the query, a uniformly drawn row of such a bulk."""
    rng = host_rng(seed, 2)
    src = rng.integers(0, n_base, n)
    bulk = np.full(n, -1, np.int64)
    if appended_share > 0 and bulk_due is not None and len(bulk_due):
        pick = rng.random(n) < appended_share
        ready = np.searchsorted(bulk_due, due - lag_s, side="right")
        ok = pick & (ready > 0)
        which = np.floor(rng.random(n) * np.maximum(ready, 1)).astype(
            np.int64)
        bulk[ok] = which[ok]
        src[ok] = rng.integers(0, bulk_rows, n)[ok]
    stream = (rng.integers(0, streams, n) if streams > 0
              else np.full(n, -1, np.int64))
    return QueryPlan(src, bulk, stream)
