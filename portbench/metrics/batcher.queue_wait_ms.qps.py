"""Mean of the batchers' ``engine.queue.wait_s`` over the window: how
long a query waited for its batch to be dequeued."""


def read(run):
    count, total = run.hist_delta("engine.queue.wait_s")
    return 1e3 * total / count if count else None
