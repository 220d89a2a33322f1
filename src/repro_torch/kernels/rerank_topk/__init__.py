"""Rerank kernel: phase-2 exact scores of a candidate page, gathered from
the table inside the kernel."""

from .ops import candidate_scores, rerank_scores, rerank_topk
from .ref import candidate_scores_ref, rerank_scores_ref

__all__ = ["rerank_scores", "candidate_scores", "rerank_topk",
           "rerank_scores_ref", "candidate_scores_ref"]
