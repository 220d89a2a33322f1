"""Inverted index over feature tokens (paper §2.3).

For every code column the documents are sorted by bucket value; the
posting list of token ``(column j, bucket b)`` is the contiguous range of
that order whose codes equal ``b``, found by binary search -- the term
dictionary lookup of a fulltext engine.  Its length is the token's
document frequency, which the idf weights of every engine read.

Scoring (the ``postings`` engine) walks the posting list of every
surviving query token and scatter-adds the token's weight into a dense
``(Q, d)`` accumulator -- the hash-map accumulator of the paper.  The
reference reads a fixed window of ``max_postings`` entries per column from
``lo``, masked past ``hi``; that is the range ``[lo, min(hi, lo +
max_postings))``, and only those ranges are gathered here, so no
``(C, max_postings)`` window exists.  ``max_postings >= n_docs`` is exact;
smaller values truncate each list as a real engine's early termination
does.

The sums run in a fixed order, the reference's: a doc sits in exactly one
posting list per code column, so one ``index_add_`` per column (a
"round"), over every query's kept range of that column into the flat
``q * d + doc`` accumulator, adds at most once to any address, and the
rounds run in increasing column order.  So every (query, doc) score is
summed from +0.0 in column order, as the reference's ``segment_sum`` over
its (C, max_postings) window sums it: the scores are the same bits from
run to run on the card, and on the CPU equal the JAX package's for the
same weights.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["Postings", "build_postings", "lookup", "df_lookup", "code_df",
           "idf_weights", "score_postings", "score_postings_batch"]

# columns sorted per step: torch.sort returns int64 indices, so sorting a
# 4M-row table whole would hold 8 bytes per code at once
_SORT_COLUMNS = 32
# posting entries gathered per step of score_postings_batch (about 36
# bytes each while a step's rounds run)
_STEP_ENTRIES = 1 << 25


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
    """Dense scores (d,): :func:`score_postings_batch` of one query."""
    return score_postings_batch(
        postings, qcodes[None], col_mask[None], max_postings, weighting,
        None if col_weights is None else col_weights[None])[0]


def score_postings_batch(
    postings: Postings,
    qcodes: torch.Tensor,       # (Q, C)
    col_mask: torch.Tensor,     # (Q, C)
    max_postings: Optional[int] = None,
    weighting: str = "idf",
    col_weights: Optional[torch.Tensor] = None,  # (Q, C) or None
) -> torch.Tensor:
    """Dense scores (Q, d) by posting-list traversal and one scatter-add
    round per column, in column order (see the module doc).  The kept
    ranges are gathered a run of columns at a time, near
    ``_STEP_ENTRIES`` entries a run; one host sync reads the entry counts
    per column."""
    C, d = postings.post_codes.shape
    Q = qcodes.shape[0]
    dev = qcodes.device
    lo, hi = lookup(postings, qcodes)                       # (Q, C)
    if weighting == "idf":
        w = idf_weights(hi - lo, postings.n_docs)
    elif weighting == "count":
        w = torch.ones((Q, C), dtype=torch.float32, device=dev)
    else:
        raise ValueError(f"unknown weighting {weighting!r}")
    if col_weights is not None:
        w = w * col_weights
    if max_postings is not None:
        hi = torch.minimum(hi, lo + max_postings)
    # the kept tokens in column-major order: column, then query
    kc, kq = (col_mask & (w != 0) & (hi > lo)).T.nonzero(as_tuple=True)
    lengths = (hi - lo)[kq, kc]
    starts = kc * d + lo[kq, kc]
    w = w[kq, kc]
    per_col = torch.zeros((2, C), dtype=torch.int64, device=dev)
    per_col[0].index_add_(0, kc, lengths)                   # entries
    per_col[1].index_add_(0, kc, torch.ones_like(kc))       # tokens
    entries, tokens = per_col.tolist()
    scores = torch.zeros((Q * d,), dtype=torch.float32, device=dev)
    post_docs = postings.post_docs.reshape(-1)
    c = t0 = 0
    while c < C:
        c1, n = c + 1, entries[c]                   # a run of columns
        while c1 < C and n + entries[c1] <= _STEP_ENTRIES:
            n += entries[c1]
            c1 += 1
        t1 = t0 + sum(tokens[c:c1])
        if n:
            ln = lengths[t0:t1]
            # every kept posting position of the run, flat over (C, d):
            # starts repeated per entry plus the entry's offset in its range
            first = torch.repeat_interleave(torch.cumsum(ln, 0) - ln, ln,
                                            output_size=n)
            pos = torch.repeat_interleave(starts[t0:t1], ln, output_size=n)
            pos += torch.arange(n, device=dev) - first
            del first
            target = torch.repeat_interleave(kq[t0:t1] * d, ln,
                                             output_size=n)
            target += post_docs[pos]
            del pos
            vals = torch.repeat_interleave(w[t0:t1], ln, output_size=n)
            o = 0
            for m in entries[c:c1]:         # one round per column
                if m:
                    scores.index_add_(0, target[o:o + m], vals[o:o + m])
                    o += m
            del target, vals
        c, t0 = c1, t1
    return scores.view(Q, d)
