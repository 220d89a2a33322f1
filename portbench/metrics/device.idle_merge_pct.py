"""Share of the traced window in which the card sat idle while the
maintenance daemon rebuilt a merge (``maintenance.merge``), and no
collection or add covered the instant (``portbench/harness/idle.py``)."""

from portbench.harness import idle


def read(run):
    return idle.share(run, "merge")
