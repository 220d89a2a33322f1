"""Inverted index over feature tokens (paper §2.3).

For every code column the documents are sorted by bucket value; the
posting list of token ``(column j, bucket b)`` is the contiguous range of
that order whose codes equal ``b``, found by binary search -- the term
dictionary lookup of a fulltext engine.  Its length is the token's
document frequency, which the idf weights of every engine read.

Scoring (the ``postings`` engine) walks the posting list of every
surviving query token and scatter-adds the token's weight into a dense
``(d,)`` accumulator -- the hash-map accumulator of the paper.  The
reference reads a fixed window of ``max_postings`` entries per column from
``lo``, masked past ``hi``; that is the range ``[lo, min(hi, lo +
max_postings))``, and only those ranges are gathered here, one query at a
time, so no ``(C, max_postings)`` window exists.  ``max_postings >= n_docs``
is exact; smaller values truncate each list as a real engine's early
termination does.  ``index_add_`` is atomic on the card, so the order of a
doc's sum changes from run to run: scores agree with the reference to
float tolerance, not bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["Postings", "build_postings", "lookup", "df_lookup", "code_df",
           "idf_weights", "score_postings", "score_postings_batch"]

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


def code_df(codes: torch.Tensor, qcodes: torch.Tensor) -> torch.Tensor:
    """Per-token document frequency against a raw ``(d, C)`` code matrix,
    a direct per-column equality count (for tables without posting
    lists): (Q, C) -> (Q, C) int32, equal to :func:`df_lookup` over the
    same codes.  One query at a time, so no (Q, d, C) tensor exists."""
    out = torch.empty(qcodes.shape, dtype=torch.int32, device=codes.device)
    for i, q in enumerate(qcodes):
        out[i] = (q[None, :] == codes).sum(dim=0, dtype=torch.int32)
    return out


def idf_weights(df: torch.Tensor, n_docs: int) -> torch.Tensor:
    """Lucene-style idf:  ln(1 + (N - df + 0.5) / (df + 0.5))."""
    df = df.to(torch.float32)
    return torch.log1p((n_docs - df + 0.5) / (df + 0.5))


def score_postings(
    postings: Postings,
    qcodes: torch.Tensor,       # (C,) query bucket codes
    col_mask: torch.Tensor,     # (C,) bool -- surviving query tokens
    max_postings: Optional[int] = None,   # None -> exact (= n_docs)
    weighting: str = "idf",     # "idf" | "count"
    col_weights: Optional[torch.Tensor] = None,  # (C,) extra weight
) -> torch.Tensor:
    """Dense scores (d,) by posting-list traversal + scatter-add."""
    C, d = postings.post_codes.shape
    lo, hi = lookup(postings, qcodes)
    if weighting == "idf":
        w = idf_weights(hi - lo, postings.n_docs)
    elif weighting == "count":
        w = torch.ones((C,), dtype=torch.float32, device=lo.device)
    else:
        raise ValueError(f"unknown weighting {weighting!r}")
    if col_weights is not None:
        w = w * col_weights
    if max_postings is not None:
        hi = torch.minimum(hi, lo + max_postings)
    keep = col_mask & (w != 0) & (hi > lo)
    lo, hi, w = lo[keep], hi[keep], w[keep]
    starts = torch.nonzero(keep).flatten() * d + lo
    lengths = hi - lo
    # every kept posting position, flat over (C, d): starts repeated per
    # entry plus the entry's offset inside its range
    first = torch.repeat_interleave(torch.cumsum(lengths, 0) - lengths,
                                    lengths)
    pos = torch.repeat_interleave(starts, lengths)
    pos += torch.arange(pos.shape[0], device=pos.device) - first
    del first
    docs = postings.post_docs.reshape(-1)[pos]
    del pos
    scores = torch.zeros((d,), dtype=torch.float32, device=lo.device)
    return scores.index_add_(0, docs, torch.repeat_interleave(w, lengths))


def score_postings_batch(
    postings: Postings,
    qcodes: torch.Tensor,       # (Q, C)
    col_mask: torch.Tensor,     # (Q, C)
    max_postings: Optional[int] = None,
    weighting: str = "idf",
    col_weights: Optional[torch.Tensor] = None,  # (Q, C) or None
) -> torch.Tensor:
    """Batched scoring, a query at a time: (Q, d)."""
    out = torch.empty((qcodes.shape[0], postings.n_docs),
                      dtype=torch.float32, device=qcodes.device)
    for i in range(qcodes.shape[0]):
        out[i] = score_postings(
            postings, qcodes[i], col_mask[i], max_postings, weighting,
            None if col_weights is None else col_weights[i])
    return out
