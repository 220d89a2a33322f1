"""Mean of the batchers' ``engine.batch.occupancy`` over the window:
filled share of each dispatched batch."""


def read(run):
    count, total = run.hist_delta("engine.batch.occupancy")
    return 100.0 * total / count if count else None
