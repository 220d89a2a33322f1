"""Mean ``search.postings.walk`` span over the window's batches: the
host issuing the posting walk, from the sync's return until the last
``index_add_`` round is issued; None without the span (a program that
has not got it)."""

from portbench.harness import idle


def read(run):
    tl = idle.timeline(run)
    if tl is None or "search.postings.walk" not in tl["names"]:
        return None
    return idle.mean_span_ms(run, "search.postings.walk")
