"""A kernel's share of its roofline in a traced window: the least time
the frozen work model allows for each launch, over the device time its
kernels took."""

from __future__ import annotations

from typing import Optional

from .work import KERNELS, bound_s


def launch_work(config: dict, kernel: str):
    """The work of one launch of ``kernel`` on the cell's base table, from
    the configuration's sizes: the whole corpus on one shard, or one
    shard's rows (with its live mask) on a doc-sharded layout."""
    model, _ = KERNELS[kernel]
    lay = config["layout"]
    shards = int(lay.get("shards", 1))
    docs = int(config["corpus"]["docs"])
    d = -(-docs // shards)
    sharded = lay["front"] == "cluster"
    Q = int(config["batcher"]["batch_size"])
    n = int(config["corpus"]["features"])
    page = min(int(config["page"]), d)
    if kernel == "fused_phase1":
        return model(d, Q, n, page, 1, sharded)
    return model(d, Q, n, page, sharded)


def roofline_pct(run, kernel: str) -> Optional[float]:
    """100 x the least seconds of a launch / the mean device seconds of a
    launch, the launch being one ``score_fold_kernel`` of the kernel's
    scorer and one ``merge_splits_kernel``, each averaged over those that
    ran wholly inside the traced window; None untraced, when the kernel
    did not run, or when launches of other shapes (appended generations)
    may be among them."""
    tr = run.trace
    if tr is None or run.mix.get("writes"):
        return None
    _, scorer = KERNELS[kernel]
    fold_s, folds = tr.op_seconds(scorer, whole=True)
    merge_s, merges = tr.op_seconds("merge_splits_kernel", whole=True)
    if folds == 0 or merges == 0:
        return None
    least, _ = bound_s(launch_work(run.config, kernel))
    return 100.0 * least / (fold_s / folds + merge_s / merges)
