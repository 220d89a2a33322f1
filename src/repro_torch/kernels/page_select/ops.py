"""Public wrapper of the page selection.

``page_select(scores, page)`` cuts a composed engine's dense (Q, d)
phase-1 scores to their page: (values (Q, page) f32, positions (Q, page)
int64), ordered by score descending and, at equal scores, position
ascending, as :func:`repro_torch.core.rerank.stable_topk` orders them.  A
CUDA tensor goes to the hand-written kernels (:mod:`.kernel`) or raises;
a CPU tensor goes to the plain version (:func:`.ref.page_select_ref`,
``stable_topk`` itself).  Both give the same bits.

``launches`` counts the CUDA kernels this wrapper launched,
``kernel.KERNELS_PER_CALL`` per call on the card (none for a matrix of no
rows).  Calls made straight to
:func:`.kernel.page_select_cuda`, as a comparison with the plain version
does, are not counted.  The count is guarded by a lock: batchers on
several threads launch at once.  The selection's cost row is filed by its
caller, ``core/search.py``'s ``select_page``.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

from repro_torch.obs import cost

from . import kernel, ref

__all__ = ["page_select", "launches"]

launches = 0
_lock = threading.Lock()


def _count(n: int) -> None:
    global launches
    with _lock:
        launches += n


def page_select(scores: torch.Tensor, page: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, positions) of the top ``page`` of every row of the (Q, d)
    ``scores``, ties to the lower position."""
    if scores.is_cuda:
        out = kernel.page_select_cuda(scores, page)
        if scores.shape[0]:          # a matrix of no rows launches nothing
            cost.count_launches(_count, kernel.KERNELS_PER_CALL)
        return out
    return ref.page_select_ref(scores, page)
