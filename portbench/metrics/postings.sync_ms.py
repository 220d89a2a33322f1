"""Mean ``search.postings.sync`` span over the window's batches: the
batcher's host blocked reading the posting walk's entry counts per
column; None without the span (a program that has not got it)."""

from portbench.harness import idle


def read(run):
    tl = idle.timeline(run)
    if tl is None or "search.postings.sync" not in tl["names"]:
        return None
    return idle.mean_span_ms(run, "search.postings.sync")
