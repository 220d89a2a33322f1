"""The arithmetic of the end-to-end metrics, over every request."""

from __future__ import annotations

import statistics
from typing import Sequence

import numpy as np


def latencies_ms(due: np.ndarray, done: np.ndarray, ok: np.ndarray
                 ) -> np.ndarray:
    """Latency of every answered request, from when it was due."""
    return (done - due)[ok] * 1e3


def window_qps(done: np.ndarray, ok: np.ndarray, t_close: float,
               seconds: float) -> float:
    """Requests answered by the window's close over the window's
    seconds."""
    return float(np.sum(ok & (done <= t_close))) / seconds


def percentile(values: np.ndarray, q: float):
    """The ``q``-th percentile of all the values (linear between order
    statistics); None for none."""
    return float(np.percentile(values, q)) if len(values) else None


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile, as Python's
    ``statistics.quantiles(values, n=4)`` gives them, over the median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
