"""Fused phase-1 kernels: scores + running top-``page`` in one pass, over
the code table (``fused_phase1``) or the int8 vector table
(``fused_phase1_quant``)."""

from .ops import fused_phase1, fused_phase1_quant
from .ref import (fused_phase1_quant_ref, fused_phase1_quant_stream,
                  fused_phase1_ref, fused_phase1_stream, match_scores)

__all__ = ["fused_phase1", "fused_phase1_quant", "fused_phase1_ref",
           "fused_phase1_stream", "fused_phase1_quant_ref",
           "fused_phase1_quant_stream", "match_scores"]
