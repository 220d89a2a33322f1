"""Share of the window's batches, over every replica group, answered by
a CUDA graph's replay: 100 x ``engine.graph.replays`` over every batch
the graph counters saw (``captures + replays + eager``); None where the
program has no such counters."""


def read(run):
    replays = run.counter_delta("engine.graph.replays")
    total = (replays + run.counter_delta("engine.graph.captures")
             + run.counter_delta("engine.graph.eager"))
    return 100.0 * replays / total if total else None
