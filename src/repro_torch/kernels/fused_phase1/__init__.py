"""Fused phase-1 kernel: code-match scores + running top-``page``."""

from .ops import fused_phase1
from .ref import fused_phase1_ref, fused_phase1_stream, match_scores

__all__ = ["fused_phase1", "fused_phase1_ref", "fused_phase1_stream",
           "match_scores"]
