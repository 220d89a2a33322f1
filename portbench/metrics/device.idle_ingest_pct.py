"""Share of the traced window in which the card sat idle while an add
held a group's engine lock (``ingest.add``), and no collection covered
the instant (``portbench/harness/idle.py``)."""

from portbench.harness import idle


def read(run):
    return idle.share(run, "ingest")
