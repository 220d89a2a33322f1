"""Evaluation metrics from paper §3.1: Precision@k, nDCG_k, avg. diff."""

from __future__ import annotations

import torch

__all__ = ["precision_at_k", "ndcg_k", "avg_diff"]


def precision_at_k(retrieved: torch.Tensor, gold: torch.Tensor) -> torch.Tensor:
    """Fraction of gold ids present in retrieved ids (both (Q, k))."""
    hit = (retrieved[:, :, None] == gold[:, None, :]).any(-1)  # (Q, k)
    return hit.to(torch.float32).mean(-1)


def ndcg_k(retrieved_sims: torch.Tensor, gold_sims: torch.Tensor) -> torch.Tensor:
    """nDCG_k with graded relevance = cosine similarity to the query.

    ``retrieved_sims``: (Q, k) cosine of the retrieved docs, in rank order.
    ``gold_sims``: (Q, k) cosine of the ideal (gold) docs, in rank order.
    """
    k = retrieved_sims.shape[-1]
    discounts = 1.0 / torch.log2(torch.arange(
        2, k + 2, dtype=torch.float32, device=retrieved_sims.device))
    dcg = (retrieved_sims * discounts).sum(-1)
    idcg = (gold_sims * discounts).sum(-1)
    return dcg / torch.clamp(idcg, min=1e-12)


def avg_diff(retrieved_sims: torch.Tensor, gold_sims: torch.Tensor) -> torch.Tensor:
    """Mean loss between ideal and actual cosine similarities of the top k."""
    return (gold_sims - retrieved_sims).mean(-1)
