"""Merge rebuilds the maintenance daemon threw away in the window, per
replica group (``maintenance.merges.discarded``): an add landed between
the rebuild's start and its compare-and-swap."""

from portbench.harness import idle


def read(run):
    if idle.timeline(run) is None:      # a program without the counter
        return None
    return run.counter_delta("maintenance.merges.discarded") / run.n_groups
