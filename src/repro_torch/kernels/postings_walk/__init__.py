"""Posting walk: the dense (Q, d) scores of the ``postings`` engine."""

from .ops import postings_walk
from .ref import postings_walk_ref

__all__ = ["postings_walk", "postings_walk_ref"]
