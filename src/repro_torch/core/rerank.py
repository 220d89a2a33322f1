"""Phase 2: exact cosine re-ranking of phase-1 candidates (paper §2.2).

All vectors are unit-normalised at index build, so cosine == dot.  Reported
scores are exact fp32: the rescore runs in plain float32, never TF32.

Every top-k here selects with a stable descending sort, so ties go to the
lower index as ``jax.lax.top_k`` does; ``torch.topk`` promises no tie order.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["normalize", "exact_scores", "rerank_topk", "brute_force_topk",
           "stable_topk", "check_fp32_matmul"]


def stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Top-``k`` along the last axis -> (values, positions); equal values
    keep ascending position order."""
    s, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], pos[..., :k]


def check_fp32_matmul(t: torch.Tensor) -> None:
    """Raise when a float32 product on ``t``'s card would run in TF32."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("exact fp32 rescore needs "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def exact_scores(vectors: torch.Tensor, ids: torch.Tensor,
                 queries: torch.Tensor) -> torch.Tensor:
    """Exact cosines of the selected ids, (Q, k) from a (Q, k, n) product."""
    check_fp32_matmul(vectors)
    return torch.einsum("qkn,qn->qk", vectors[ids], queries)


def rerank_topk(
    vectors: torch.Tensor,    # (d, n) unit-normalised index vectors
    cand_ids: torch.Tensor,   # (Q, page) phase-1 candidates
    queries: torch.Tensor,    # (Q, n) unit-normalised queries
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k among the candidates -> (ids (Q,k), scores (Q,k))."""
    check_fp32_matmul(vectors)
    cand_ids = cand_ids.long()
    scores = torch.einsum("qpn,qn->qp", vectors[cand_ids], queries)
    _, top_pos = stable_topk(scores, k)
    top_ids = torch.gather(cand_ids, 1, top_pos)
    return top_ids.to(torch.int32), exact_scores(vectors, top_ids, queries)


def brute_force_topk(
    vectors: torch.Tensor,   # (d, n)
    queries: torch.Tensor,   # (Q, n)
    k: int,
    block: int = 262144,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's naive baseline: one linear scan -> (ids (Q,k), scores).

    The doc axis is walked in blocks folded into a running stable top-k,
    so no (Q, d) matrix larger than a block ever exists.  ``k`` clamps to
    the corpus size."""
    check_fp32_matmul(vectors)
    d = vectors.shape[0]
    k = min(k, d)
    Q = queries.shape[0]
    dev = vectors.device
    best_s = torch.full((Q, 0), float("-inf"), device=dev)
    best_i = torch.zeros((Q, 0), dtype=torch.int64, device=dev)
    for base in range(0, d, block):
        s = queries @ vectors[base:base + block].T              # (Q, b)
        ids = torch.arange(base, base + s.shape[1], device=dev)
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, ids.expand(Q, -1)], dim=1)
        best_s, pos = stable_topk(cat_s, k)
        best_i = torch.gather(cat_i, 1, pos)
    return best_i.to(torch.int32), best_s
