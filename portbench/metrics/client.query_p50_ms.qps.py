"""Median latency of every query of the window, as ``query_p50_ms``
takes it, where it drifts too widely between runs to hold to a bound: an
open loop under writes, whose searches slow as generations gather."""

from portbench.harness.stats import percentile


def read(run):
    return percentile(run.latency_ms, 50)
