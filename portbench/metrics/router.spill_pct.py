"""Share of the window's routed queries that the cluster router spilled
off their pinned replica group (``cluster.routing.spills`` over
``cluster.requests.submitted``)."""


def read(run):
    routed = run.counter_delta("cluster.requests.submitted")
    if not routed:
        return None
    return 100.0 * run.counter_delta("cluster.routing.spills") / routed
