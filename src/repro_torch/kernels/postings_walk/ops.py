"""Public wrapper of the posting walk.

``postings_walk`` writes the (Q, d) f32 scores of the ``postings``
engine's phase 1 from each (query, column)'s posting range ``[lo, hi)``
of ``post_docs`` and its weight (``core/postings.py``'s
``score_postings_batch`` empties the range of every token it does not
walk).  A CUDA tensor goes to the hand-written kernel (:mod:`.kernel`) or
raises; a CPU tensor goes to the plain version
(:func:`.ref.postings_walk_ref`).  Both give the same bits.

``launches`` counts the CUDA kernels this wrapper launched, two per call
on the card (the cut and the walk).  Calls made straight to
:func:`.kernel.postings_walk_cuda`, as a comparison with the plain
version does, are not counted.  The count is guarded by a lock: batchers
on several threads launch at once.  The walk's cost row is filed by its
caller, ``core/search.py``'s ``phase1_engine_scores``, from the entry
count the walk's sync read.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.obs import cost

from . import kernel, ref

__all__ = ["postings_walk", "launches"]

launches = 0
_lock = threading.Lock()


def _count(n: int) -> None:
    global launches
    with _lock:
        launches += n


def postings_walk(
    post_docs: torch.Tensor,    # (C, d) int32, each token's range ascending
    lo: torch.Tensor,           # (Q, C) int64 range starts
    hi: torch.Tensor,           # (Q, C) int64 range ends, <= lo if not walked
    w: torch.Tensor,            # (Q, C) f32
) -> torch.Tensor:
    """(Q, d) f32 scores: each token's weight added, in column order from
    +0.0, at the docs of its range."""
    if post_docs.is_cuda:
        out = kernel.postings_walk_cuda(post_docs, lo, hi, w)
        cost.count_launches(_count, kernel.KERNELS_PER_CALL)
        return out
    return ref.postings_walk_ref(post_docs, lo, hi, w)
