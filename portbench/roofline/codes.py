"""The least time of a batch's phase 1 on the ``codes`` engine:
``fused_phase1``'s frozen bound at the cell's shapes (the same page by
scoring every row, Q·d·C comparisons at the CUDA cores' rate), scaled by
the comparisons the batch made over Q·d·C.  Taking the scan's bound makes
the share read the same work whatever implements phase 1.
"""

from __future__ import annotations

from .share import launch_work
from .work import bound_s


def least_phase1_s(config: dict, cells: float) -> float:
    """The least seconds of one batch's phase 1 at the configuration's
    shapes, with ``cells`` (query, doc, column) comparisons to make."""
    Q = int(config["batcher"]["batch_size"])
    d = int(config["corpus"]["docs"])
    C = int(config["corpus"]["features"])
    scan, _ = bound_s(launch_work(config, "fused_phase1"))
    return scan * cells / (Q * d * C)
