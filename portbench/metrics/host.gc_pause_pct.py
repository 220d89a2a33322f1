"""Share of the window in which the interpreter's cyclic garbage
collector ran (every generation), timed by ``gc.callbacks``: it holds
every thread of the process, the batchers' and the clients' alike."""


def read(run):
    return 100.0 * sum(b - a for _, a, b in run.gc_pauses) / run.seconds
