"""Mean of the batchers' ``engine.ingest.latency_s`` over the window's
adds: one replica group's add of one bulk, under its engine lock."""


def read(run):
    count, total = run.hist_delta("engine.ingest.latency_s")
    return 1e3 * total / count if count else None
