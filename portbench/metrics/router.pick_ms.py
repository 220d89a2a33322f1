"""Mean ``router.pick`` span over the window's routed submits: the
cluster router choosing a query's group, on the submitting thread (it
reads every group's ``pending`` under the lock an add holds)."""

from portbench.harness import idle


def read(run):
    return idle.mean_span_ms(run, "router.pick")
