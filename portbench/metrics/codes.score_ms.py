"""Mean ``search.codes.score`` span over the window's batches: the host
issuing the ``codes`` engine's block loop (the compare, cast, ``bmm`` and
write of every doc block); None without the span (a program that has not
got it)."""

from portbench.harness import idle


def read(run):
    tl = idle.timeline(run)
    if tl is None or "search.codes.score" not in tl["names"]:
        return None
    return idle.mean_span_ms(run, "search.codes.score")
