"""Public wrapper of the rerank kernel: phase 2 as gather -> kernel scores
-> stable top-k -> exact rescore.

``rerank_topk(vectors, cand_ids, queries, k)`` is the kernel form of
:func:`repro_torch.core.rerank.rerank_topk`: the kernel scores the
candidates straight from the (d, n) table, the top ``k`` are selected with
a stable sort (ties to the lower page position, as ``jax.lax.top_k``
breaks them), and the reported scores are recomputed by
:func:`repro_torch.core.rerank.exact_scores` at (Q, k, n), the same
final-score contract as the core path.  ``rerank_scores(cand_vecs,
queries)`` keeps the reference's signature over gathered (Q, P, n)
candidates and runs the same kernel over them as a (Q * P, n) table.

A CUDA tensor goes to the hand-written kernel (:mod:`.kernel`) or raises;
a CPU tensor goes to the plain version (:mod:`.ref`).  ``launches`` counts
the CUDA kernels this wrapper launched, one per call on the card, and
``launches_by_body`` the same launches by the body the launch plan chose
(``"bulk"`` or ``"simple"``, :mod:`.kernel`); calls made straight to
:func:`.kernel.rerank_scores_cuda`, as a comparison with the plain version
does, are not counted.  Both counts are guarded by one lock: batchers on
several threads launch at once.  Each scoring call, on either path, first
files its work as a cost row (:func:`repro_torch.obs.cost.kernel_call`),
counting every one of the Q * P candidate rows: the wrapper reads no ids.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

from repro_torch.core.rerank import exact_scores, stable_topk
from repro_torch.obs import cost

from . import kernel, ref

__all__ = ["rerank_scores", "candidate_scores", "rerank_topk", "launches",
           "launches_by_body"]

launches = 0
launches_by_body = dict.fromkeys(kernel.BODIES, 0)
_lock = threading.Lock()


def _launch(table, ids, queries):
    global launches
    out, plan = kernel.launch(table, ids, queries)
    with _lock:
        launches += kernel.KERNELS_PER_CALL
        launches_by_body[plan.body] += 1
    return out


def rerank_scores(cand_vecs: torch.Tensor,
                  queries: torch.Tensor) -> torch.Tensor:
    """(Q, P, n) gathered candidates, (Q, n) queries -> (Q, P) scores."""
    if cand_vecs.dim() != 3:
        raise ValueError("cand_vecs must be a contiguous (Q, P, n) tensor")
    Q, P, n = cand_vecs.shape
    with cost.kernel_call("rerank_topk", cost.rerank_work(Q, P, n, Q * P)):
        if not cand_vecs.is_cuda:
            return ref.rerank_scores_ref(cand_vecs, queries)
        if not cand_vecs.is_contiguous():
            raise ValueError("cand_vecs must be a contiguous (Q, P, n) "
                             "tensor")
        ids = torch.arange(Q * P, dtype=torch.int32,
                           device=cand_vecs.device).view(Q, P)
        return _launch(cand_vecs.view(Q * P, n), ids, queries)


def candidate_scores(vectors: torch.Tensor, cand_ids: torch.Tensor,
                     queries: torch.Tensor) -> torch.Tensor:
    """(d, n) table, (Q, P) ids, (Q, n) queries -> (Q, P) scores of the
    rows ``vectors[cand_ids]``, never gathered on the card."""
    Q, P = cand_ids.shape
    with cost.kernel_call("rerank_topk", cost.rerank_work(
            Q, P, vectors.shape[-1], Q * P)):
        if vectors.is_cuda:
            if cand_ids.dtype != torch.int32 or not cand_ids.is_contiguous():
                cand_ids = cand_ids.to(torch.int32).contiguous()
            return _launch(vectors, cand_ids, queries)
        return ref.candidate_scores_ref(vectors, cand_ids, queries)


def rerank_topk(
    vectors: torch.Tensor,    # (d, n) index vectors, unit rows
    cand_ids: torch.Tensor,   # (Q, page) phase-1 candidates
    queries: torch.Tensor,    # (Q, n) unit rows
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k among the candidates -> (ids (Q, k) int32,
    scores (Q, k) f32); see the module doc."""
    scores = candidate_scores(vectors, cand_ids, queries)
    _, top_pos = stable_topk(scores, k)
    top_ids = torch.gather(cand_ids.long(), 1, top_pos)
    return top_ids.to(torch.int32), exact_scores(vectors, top_ids, queries)
