"""Mean of ``engine.dispatch.latency_s`` over the window: the host clock
around one batch's search and its answer's copy to the host."""


def read(run):
    count, total = run.hist_delta("engine.dispatch.latency_s")
    return 1e3 * total / count if count else None
