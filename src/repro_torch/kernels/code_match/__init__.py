"""Code-match kernel: the full (Q, d) weighted code-equality matrix."""

from .ops import code_match
from .ref import code_match_ref

__all__ = ["code_match", "code_match_ref"]
