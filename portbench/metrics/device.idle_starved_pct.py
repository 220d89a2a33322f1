"""Share of the traced window in which the card sat idle while every
batcher thread waited for queries (``batcher.wait``), and no collection,
add or merge covered the instant (``portbench/harness/idle.py``)."""

from portbench.harness import idle


def read(run):
    return idle.share(run, "starved")
