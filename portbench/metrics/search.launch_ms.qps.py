"""Mean ``search.launch`` span over the window's batches: the batcher's
host time from dispatch to just before the answers' copies, issuing the
search's work; ``search.dispatch_ms`` less this is the host's wait on
the card."""

from portbench.harness import idle


def read(run):
    return idle.mean_span_ms(run, "search.launch")
