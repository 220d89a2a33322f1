"""Open loop: 95th percentile of how late a client thread sent a query
after it was due, over the window's queries."""

from portbench.harness.stats import percentile


def read(run):
    if not run.open_loop or run.n_window == 0:
        return None
    sl = run.window_slice()
    lag = (run.rec.sent[sl] - run.rec.due[sl]) * 1e3
    return percentile(lag, 95)
