"""Inverted index over feature tokens (paper §2.3).

For every code column the documents are sorted by bucket value; the
posting list of token ``(column j, bucket b)`` is the contiguous range of
that order whose codes equal ``b``, found by binary search -- the term
dictionary lookup of a fulltext engine.  Its length is the token's
document frequency, which the idf weights of every engine read.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = ["Postings", "build_postings", "lookup", "df_lookup", "idf_weights"]

# columns sorted per step: torch.sort returns int64 indices, so sorting a
# 4M-row table whole would hold 8 bytes per code at once
_SORT_COLUMNS = 32


class Postings(NamedTuple):
    """Per column, doc ids sorted by their bucket code."""

    post_docs: torch.Tensor   # (C, d) int32 -- doc ids, sorted by code per column
    post_codes: torch.Tensor  # (C, d) intN  -- the sorted codes themselves
    n_docs: int


def build_postings(codes: torch.Tensor) -> Postings:
    """codes: (d, C) -> Postings, by a stable sort of every column.

    Columns are sorted a block at a time into preallocated int32 tables,
    so the int64 sort indices never exist for the whole table."""
    d, C = codes.shape
    post_docs = torch.empty((C, d), dtype=torch.int32, device=codes.device)
    post_codes = torch.empty((C, d), dtype=codes.dtype, device=codes.device)
    for j in range(0, C, _SORT_COLUMNS):
        vals, order = torch.sort(codes[:, j:j + _SORT_COLUMNS], dim=0,
                                 stable=True)
        post_docs[j:j + _SORT_COLUMNS] = order.T
        post_codes[j:j + _SORT_COLUMNS] = vals.T
        del vals, order
    return Postings(post_docs=post_docs, post_codes=post_codes, n_docs=d)


def lookup(postings: Postings,
           qcodes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary-search every query token's posting range.

    qcodes: (C,) or (Q, C) -> (lo, hi) of the same shape, int64; ``hi - lo``
    is the token's document frequency.  One batched ``searchsorted`` over
    the C sorted rows answers every query at once."""
    C = postings.post_codes.shape[0]
    qt = qcodes.reshape(-1, C).T.contiguous().to(postings.post_codes.dtype)
    lo = torch.searchsorted(postings.post_codes, qt, side="left")
    hi = torch.searchsorted(postings.post_codes, qt, side="right")
    return lo.T.reshape(qcodes.shape), hi.T.reshape(qcodes.shape)


def df_lookup(postings: Postings, qcodes: torch.Tensor) -> torch.Tensor:
    """Per-token document frequencies off the posting lists:
    (Q, C) -> (Q, C) int32."""
    lo, hi = lookup(postings, qcodes)
    return (hi - lo).to(torch.int32)


def idf_weights(df: torch.Tensor, n_docs: int) -> torch.Tensor:
    """Lucene-style idf:  ln(1 + (N - df + 0.5) / (df + 0.5))."""
    df = df.to(torch.float32)
    return torch.log1p((n_docs - df + 0.5) / (df + 0.5))
