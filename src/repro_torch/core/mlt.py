"""More-Like-This (MLT) baseline (paper §3.1 / Table 4).

The paper compares against Elasticsearch's native MLT query: the raw
article *text* is indexed, and a query document's ``max_query_terms``
highest-tf-idf terms form a boolean OR query scored by the engine's
default term weighting.  This reproduces that algorithm over bag-of-words
corpora: an inverted index over *terms* (not feature tokens), query-term
selection by tf-idf, and presence x idf x log-tf scoring.  Unlike the
encoded-vector method there is no phase-2 re-rank -- MLT's own top-k is
the result, as evaluated in the paper.

The reference reads a fixed window of ``max_postings`` entries per
selected term from the start of its posting range, masked past its end;
that is the range ``[lo, min(hi, lo + max_postings))``, and only those
ranges are gathered here, for all queries at once, and added into a
(Q, d) accumulator in a fixed order: one ``index_add_`` per selected-term
slot (a "round"), slots in order.  A term's posting list names each doc
once, so no round adds twice to one (query, doc), and every score is
summed from +0.0 in the query's term-selection order: the same bits from
run to run on the card.  Both top-k selections are stable (ties to the
lower index, as ``jax.lax.top_k`` breaks them).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from .rerank import stable_topk

__all__ = ["MLTIndex"]


class TermPostings(NamedTuple):
    sorted_terms: torch.Tensor  # (nnz,) int32 term ids, ascending (pads last)
    sorted_docs: torch.Tensor   # (nnz,) int32 doc ids
    sorted_tf: torch.Tensor     # (nnz,) f32 term frequency in that doc
    idf: torch.Tensor           # (vocab,) f32
    n_docs: int


@dataclasses.dataclass
class MLTIndex:
    """Term-space fulltext index with a More-Like-This query API."""

    postings: TermPostings
    doc_terms: torch.Tensor    # (d, T) int32 padded with -1
    doc_tf: torch.Tensor       # (d, T) f32

    @property
    def device(self) -> torch.device:
        return self.doc_terms.device

    @classmethod
    def build(cls, doc_terms, doc_tf, vocab_size: int,
              device="cuda") -> "MLTIndex":
        """doc_terms: (d, T) padded term ids (-1 = pad), doc_tf: (d, T)
        counts, numpy or tensors; the index lives on ``device``."""
        doc_terms = torch.as_tensor(doc_terms, device=device).to(torch.int32)
        doc_tf = torch.as_tensor(doc_tf, device=device).to(torch.float32)
        d, T = doc_terms.shape
        terms = doc_terms.reshape(-1)
        docs = torch.arange(d, dtype=torch.int32,
                            device=device).repeat_interleave(T)
        # push pads to the end by mapping -1 -> vocab_size
        key = torch.where(terms < 0, vocab_size, terms)
        order = torch.argsort(key, stable=True)
        df = torch.zeros(vocab_size + 1, dtype=torch.float32, device=device)
        df.index_add_(0, key.long(), (terms >= 0).to(torch.float32))
        df = df[:vocab_size]
        idf = torch.log1p((d - df + 0.5) / (df + 0.5))
        return cls(TermPostings(key[order], docs[order],
                                doc_tf.reshape(-1)[order], idf, d),
                   doc_terms, doc_tf)

    # ------------------------------------------------------------------ query
    def scores(
        self,
        query_terms,                # (Q, T) padded term ids (-1 = pad)
        query_tf,                   # (Q, T)
        max_query_terms: int = 25,
        max_postings: int = 4096,
    ) -> torch.Tensor:
        """MLT scores (Q, d) f32 of every doc, on the index's device: the
        query doc's top terms by tf-idf, each adding idf x (1 + log1p(tf))
        to the docs of its posting window, one round per term slot."""
        p = self.postings
        dev = self.device
        qt = torch.as_tensor(query_terms, device=dev).long()
        tf = torch.as_tensor(query_tf, device=dev).to(torch.float32)
        Q, T = qt.shape
        d = p.n_docs
        tid = torch.clamp(qt, min=0)
        # MLT term selection: top terms of the query doc by tf-idf
        tfidf = torch.where(qt >= 0, (1.0 + torch.log1p(tf)) * p.idf[tid],
                            float("-inf"))
        sel_w, sel_pos = stable_topk(tfidf, min(max_query_terms, T))
        sel_terms = torch.gather(tid, 1, sel_pos)
        lo = torch.searchsorted(p.sorted_terms, sel_terms.to(torch.int32),
                                side="left")
        hi = torch.searchsorted(p.sorted_terms, sel_terms.to(torch.int32),
                                side="right")
        hi = torch.minimum(hi, lo + max_postings)
        # the kept (query, slot) pairs in round order: slot, then query
        kj, kq = (torch.isfinite(sel_w) & (hi > lo)).T.nonzero(as_tuple=True)
        lo, lengths = lo[kq, kj], (hi - lo)[kq, kj]
        per_slot = torch.zeros(sel_w.shape[1], dtype=torch.int64, device=dev)
        per_slot = per_slot.index_add_(0, kj, lengths).tolist()
        n = sum(per_slot)
        # every kept posting position, in round order
        first = torch.repeat_interleave(torch.cumsum(lengths, 0) - lengths,
                                        lengths, output_size=n)
        pos = torch.repeat_interleave(lo, lengths, output_size=n)
        pos += torch.arange(n, device=dev) - first
        del first
        w = torch.repeat_interleave(p.idf[sel_terms[kq, kj]], lengths,
                                    output_size=n)
        w *= 1.0 + torch.log1p(p.sorted_tf[pos])
        flat = torch.repeat_interleave(kq * d, lengths, output_size=n)
        flat += p.sorted_docs[pos]
        del pos
        scores = torch.zeros(Q * d, dtype=torch.float32, device=dev)
        o = 0
        for m in per_slot:                  # one round per term slot
            if m:
                scores.index_add_(0, flat[o:o + m], w[o:o + m])
                o += m
        return scores.view(Q, d)

    def more_like_this(
        self,
        query_terms,                # (Q, T) padded term ids (-1 = pad)
        query_tf,                   # (Q, T)
        max_query_terms: int = 25,
        k: int = 10,
        max_postings: int = 4096,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (ids (Q, k) int32, mlt scores (Q, k) f32), on the index's
        device: the stable top-``k`` of :meth:`scores`."""
        top_s, top_i = stable_topk(
            self.scores(query_terms, query_tf, max_query_terms, max_postings),
            k)
        return top_i.to(torch.int32), top_s
