"""The paper's contribution: semantic vector encoding + two-phase search."""

from .encoding import CombinedEncoder, IntervalEncoder, RoundingEncoder
from .filtering import BestFilter, TrimFilter
from .metrics import avg_diff, ndcg_k, precision_at_k
from .mlt import MLTIndex
from .rerank import brute_force_topk, normalize, rerank_topk
from .search import FUSED_ENGINES, SearchParams, VectorIndex

__all__ = [
    "CombinedEncoder",
    "IntervalEncoder",
    "RoundingEncoder",
    "BestFilter",
    "TrimFilter",
    "MLTIndex",
    "VectorIndex",
    "SearchParams",
    "FUSED_ENGINES",
    "avg_diff",
    "ndcg_k",
    "precision_at_k",
    "brute_force_topk",
    "normalize",
    "rerank_topk",
]
