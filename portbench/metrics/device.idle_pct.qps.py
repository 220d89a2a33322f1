"""Share of the traced window in which no operation ran on the card (one
minus the union of device-op intervals)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
