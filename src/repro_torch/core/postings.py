"""Inverted index over feature tokens (paper §2.3).

For every code column the documents are sorted by bucket value; the
posting list of token ``(column j, bucket b)`` is the contiguous range of
that order whose codes equal ``b``, found by binary search -- the term
dictionary lookup of a fulltext engine.  Its length is the token's
document frequency, which the idf weights of every engine read.

The invariant the walk rests on: every table is built by
:func:`build_postings`'s stable sort of each column (a sharded index's
tables per shard, a merge's rebuilt ones and a restored store's alike),
so within one token's range ``[lo, hi)`` of ``post_docs[c]`` the doc ids
ascend.  A range's docs in any doc interval are then one contiguous
sub-range of it, two binary searches away.

Scoring (the ``postings`` engine) walks the posting list of every
surviving query token and adds the token's weight into a dense ``(Q, d)``
accumulator -- the hash-map accumulator of the paper.  The reference
reads a fixed window of ``max_postings`` entries per column from ``lo``,
masked past ``hi``; that is the range ``[lo, min(hi, lo + max_postings))``
(still contiguous and ascending), and only those ranges are walked, so no
``(C, max_postings)`` window exists.  ``max_postings >= n_docs`` is
exact; smaller values truncate each list as a real engine's early
termination does.  The walk is
:func:`repro_torch.kernels.postings_walk.ops.postings_walk`: on the card
one hand-written kernel whose blocks each own a doc tile of one query's
accumulator in shared memory, on the CPU the plain version, which expands
the ranges and adds them by one ``index_add_`` round a column.

The sums run in a fixed order, the reference's: a doc sits in exactly one
posting list per code column, so every (query, doc) score is summed from
+0.0 in increasing column order, each column adding at most once to it,
as the reference's ``segment_sum`` over its (C, max_postings) window sums
it: the scores are the same bits from run to run and on the card and the
CPU, and on the CPU equal the JAX package's for the same weights.

The host sync that reads the entry and token counts per column is timed
as ``search.postings.sync`` under an engine's timeline sink, and the
issue of the walk after it as ``search.postings.walk``
(:mod:`repro_torch.obs.tracing`); a :class:`WalkTally` active on the
thread sums what each walk did from the counts that sync read.  Neither
adds a synchronisation.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.postings_walk import ops as walk_ops
from repro_torch.obs.tracing import child_clock

__all__ = ["Postings", "build_postings", "lookup", "df_lookup", "code_df",
           "idf_weights", "score_postings", "score_postings_batch",
           "WalkTally"]

# columns sorted per step: torch.sort returns int64 indices, so sorting a
# 4M-row table whole would hold 8 bytes per code at once
_SORT_COLUMNS = 32


class WalkTally:
    """What the walks of :func:`score_postings_batch` on this thread did
    while the tally is active (``with tally:``), summed: ``entries``, the
    posting entries walked (over the kept tokens, each token's document
    frequency ``hi - lo``, capped at ``max_postings`` where set);
    ``tokens``, the kept tokens with a non-empty list; ``rounds``, the
    columns that hold an entry: the column steps of the walk (inside the
    kernel on the card, one ``index_add_`` round each in the plain
    version).  A tally opened inside another adds its sums to the outer
    one when it closes."""

    __slots__ = ("entries", "tokens", "rounds", "_prev")

    def __init__(self):
        self.entries = self.tokens = self.rounds = 0

    def __enter__(self) -> "WalkTally":
        self._prev = _TALLY.tally
        _TALLY.tally = self
        return self

    def __exit__(self, *exc) -> bool:
        _TALLY.tally = prev = self._prev
        if prev is not None:
            prev.entries += self.entries
            prev.tokens += self.tokens
            prev.rounds += self.rounds
        return False


class _Local(threading.local):
    tally: Optional[WalkTally] = None


_TALLY = _Local()


class Postings(NamedTuple):
    """Per column, doc ids sorted by their bucket code."""

    post_docs: torch.Tensor   # (C, d) int32 -- doc ids, sorted by code per column
    post_codes: torch.Tensor  # (C, d) intN  -- the sorted codes themselves
    n_docs: int


def build_postings(codes: torch.Tensor, out=None) -> Postings:
    """codes: (d, C) -> Postings, by a stable sort of every column.

    Columns are sorted a block at a time into preallocated int32 tables
    (``out``: a (post_docs, post_codes) pair of (C, d) tensors to fill,
    such as one shard's slices of a sharded index's tables), so the int64
    sort indices never exist for the whole table."""
    d, C = codes.shape
    if out is None:
        out = (torch.empty((C, d), dtype=torch.int32, device=codes.device),
               torch.empty((C, d), dtype=codes.dtype, device=codes.device))
    post_docs, post_codes = out
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
    """Dense scores (Q, d) by posting-list traversal, summed in column
    order (see the module doc): the lookup, the kept tokens, one host
    sync for the entry and token counts per column, then the walk of the
    kept ranges."""
    C = postings.post_codes.shape[0]
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
    # the kept tokens' ranges; every other token's range emptied
    hi = torch.where(col_mask & (w != 0) & (hi > lo), hi, lo)
    per_col = torch.stack(((hi - lo).sum(0), (hi > lo).sum(0)))
    clock = child_clock()
    entries, tokens = per_col.tolist()
    rounds = C - entries.count(0)
    if clock is not None:
        clock.close("search.postings.sync", sum(tokens), rounds)
    tally = _TALLY.tally
    if tally is not None:
        tally.entries += sum(entries)
        tally.tokens += sum(tokens)
        tally.rounds += rounds
    scores = walk_ops.postings_walk(postings.post_docs, lo, hi, w)
    if clock is not None:
        clock.close("search.postings.walk")
    return scores
