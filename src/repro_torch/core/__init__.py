"""The paper's contribution: semantic vector encoding + two-phase search."""

from .encoding import CombinedEncoder, IntervalEncoder, RoundingEncoder
from .filtering import BestFilter, TrimFilter
from .rerank import brute_force_topk, normalize, rerank_topk
from .search import FUSED_ENGINES, VectorIndex

__all__ = [
    "CombinedEncoder",
    "IntervalEncoder",
    "RoundingEncoder",
    "BestFilter",
    "TrimFilter",
    "VectorIndex",
    "FUSED_ENGINES",
    "brute_force_topk",
    "normalize",
    "rerank_topk",
]
