"""Plain PyTorch versions of the rerank kernel.

:func:`rerank_scores_ref` is the reference's oracle on gathered
candidates, ``scores[q, p] = sum_n cand[q, p, n] * query[q, n]`` as one
einsum; :func:`candidate_scores_ref` is the function the CUDA kernel
computes, the gather of the candidate rows by id and then the same
einsum.  Both run in plain float32 (TF32 off on the card).
"""

from __future__ import annotations

import torch

from repro_torch.core.rerank import check_fp32_matmul

__all__ = ["rerank_scores_ref", "candidate_scores_ref"]


def rerank_scores_ref(cand_vecs: torch.Tensor,
                      queries: torch.Tensor) -> torch.Tensor:
    """(Q, P, n), (Q, n) -> (Q, P) exact cosine (inputs unit-normalised)."""
    check_fp32_matmul(cand_vecs)
    return torch.einsum("qpn,qn->qp", cand_vecs, queries)


def candidate_scores_ref(vectors: torch.Tensor, cand_ids: torch.Tensor,
                         queries: torch.Tensor) -> torch.Tensor:
    """(d, n) table, (Q, P) ids, (Q, n) queries -> (Q, P) scores."""
    return rerank_scores_ref(vectors[cand_ids.long()], queries)
