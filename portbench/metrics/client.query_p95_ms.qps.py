"""95th percentile latency of every query of the window, as
``query_p95_ms`` takes it, where it swings too widely between runs to
hold to a bound: a closed loop at capacity, an open loop under writes."""

from portbench.harness.stats import percentile


def read(run):
    return percentile(run.latency_ms, 95)
