"""Segment merges the maintenance daemon applied in the window, per
replica group (``maintenance.merges``).  A merge is rebuilt outside the
engine lock and installed only if no add came meanwhile, so a merge that
outlasts the gap between adds is thrown away and the generations pile
up."""


def read(run):
    if not run.mix.get("writes"):
        return None
    return run.counter_delta("maintenance.merges") / run.n_groups
