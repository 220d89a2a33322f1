"""Share of the traced window in which the card sat idle while a
batcher thread formed a batch, launched its search, waited on its
answer's copy or delivered it (``batcher.form``, ``search.launch``,
``search.answer_wait``, ``batcher.deliver``), and no collection, add or
merge covered the instant (``portbench/harness/idle.py``)."""

from portbench.harness import idle


def read(run):
    return idle.share(run, "host")
