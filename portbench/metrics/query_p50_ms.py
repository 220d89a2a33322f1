"""Median latency of every query sent in the window (open loop: from when
it was due; closed loop: from when it was sent)."""

from portbench.harness.stats import percentile


def read(run):
    return percentile(run.latency_ms, 50)
