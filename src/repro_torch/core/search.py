"""Public two-phase search API (paper §2.2): VectorIndex.

    idx = VectorIndex.build(vectors, encoder=RoundingEncoder(2))
    ids, sims = idx.search(queries, k=10, page=320, trim=TrimFilter(0.05),
                           engine="fused")

Phase 1 retrieves ``page`` candidates; phase 2 re-ranks them by exact fp32
cosine (:mod:`repro_torch.core.rerank`).  The engine ported so far is
``fused``: code-match scoring and a running top-``page`` in one kernel
pass (:mod:`repro_torch.kernels.fused_phase1`), never a (Q, n_docs) score
matrix.  Every other engine of the reference raises
``NotImplementedError`` naming the ROADMAP item that ports it.

Filtering (trim/best) is query-side, choosable per request, with optional
index-side ``best`` at build time.  The index lives on one device
(``device``, ``"cuda"`` unless the caller asks for the CPU) and makes
every tensor there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .encoding import Encoder, RoundingEncoder
from .filtering import (BestFilter, TrimFilter, expand_mask, feature_mask,
                        index_best_codes)
from .postings import Postings, build_postings, df_lookup, idf_weights
from .rerank import brute_force_topk, normalize, rerank_topk

__all__ = ["VectorIndex", "FUSED_ENGINES"]

# engines that fuse phase-1 scoring with candidate selection
FUSED_ENGINES = ("fused", "fused_int8")

# the ROADMAP item that ports each engine not ported yet
_NOT_PORTED = {
    "postings": "Queue 1 item 2 (with core/postings.py score_postings)",
    "codes": "Queue 1 item 2 (with core/codes.py)",
    "onehot": "Queue 1 item 2 (with core/codes.py)",
    "codes_pallas": "Queue 1 item 2 and Queue 2 item 3 (code_match kernel)",
    "fused_int8": "Queue 1 item 2 and Queue 2 item 2 (fused_phase1_quant "
                  "kernel, core/quantize.py)",
}

_SENTINEL = {  # never-matching code per dtype (outside any bucket range)
    torch.int8: 127,
    torch.int16: 32767,
    torch.int32: 2**31 - 1,
}

# rows encoded per step at build: the elementwise temporaries of encode
# then stay a few hundred MB at paper scale
_ENCODE_ROWS = 1 << 18


@dataclasses.dataclass
class VectorIndex:
    """Immutable two-phase search index over unit-normalised vectors."""

    vectors: torch.Tensor          # (d, n) f32, unit rows
    codes: torch.Tensor            # (d, C) int
    postings: Postings
    encoder: Encoder
    index_best: Optional[int]      # index-side 'best' filter used at build

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    # ------------------------------------------------------------------ build
    @classmethod
    def build(
        cls,
        vectors,
        encoder: Encoder = RoundingEncoder(2),
        index_best: Optional[int] = None,
        device="cuda",
    ) -> "VectorIndex":
        """Normalize -> encode -> optional index-side best -> posting
        tables, all on ``device``.  The input may be numpy or a tensor."""
        vectors = normalize(torch.as_tensor(vectors, dtype=torch.float32,
                                            device=device))
        parts = []
        for r in range(0, vectors.shape[0], _ENCODE_ROWS):
            rows = vectors[r:r + _ENCODE_ROWS]
            c = encoder.encode(rows)
            if index_best is not None:
                c = index_best_codes(rows, c, index_best, _SENTINEL[c.dtype])
            parts.append(c)
        codes = torch.cat(parts) if len(parts) > 1 else parts[0]
        del parts
        return cls(vectors, codes, build_postings(codes), encoder, index_best)

    @property
    def n_docs(self) -> int:
        return self.vectors.shape[0]

    @property
    def n_features(self) -> int:
        return self.vectors.shape[1]

    # ---------------------------------------------------------- query encode
    def encode_queries(
        self,
        queries,
        trim: Optional[TrimFilter],
        best: Optional[BestFilter],
        weighting: str,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (queries_normalised (Q,n), qcodes (Q,C), col_weights (Q,C))."""
        q = normalize(torch.as_tensor(queries, dtype=torch.float32,
                                      device=self.device))
        qcodes = self.encoder.encode(q)
        mask = expand_mask(feature_mask(q, trim=trim, best=best),
                           qcodes.shape[-1])
        if weighting == "idf":
            w = idf_weights(df_lookup(self.postings, qcodes),
                            self.postings.n_docs)
        elif weighting == "count":
            w = torch.ones(qcodes.shape, dtype=torch.float32,
                           device=self.device)
        else:
            raise ValueError(f"unknown weighting {weighting!r}")
        return q, qcodes, torch.where(mask, w, 0.0)

    # ------------------------------------------------------------------ search
    def search(
        self,
        queries,
        k: int = 10,
        page: int = 320,
        trim: Optional[TrimFilter] = None,
        best: Optional[BestFilter] = None,
        engine: str = "fused",
        weighting: str = "idf",
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Two-phase search -> (ids (Q,k) int32, cosine scores (Q,k) f32),
        on the index's device.  Only ``engine="fused"`` is ported; phase 2
        is the exact-fp32 rerank."""
        if engine != "fused":
            if engine in _NOT_PORTED:
                raise NotImplementedError(
                    f"engine {engine!r} is not ported to repro_torch yet: "
                    f"ROADMAP {_NOT_PORTED[engine]}; use engine='fused'")
            raise ValueError(f"unknown engine {engine!r}")
        from repro_torch.kernels.fused_phase1 import ops as fp_ops

        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        queries = torch.atleast_2d(queries)
        page = min(page, self.n_docs)
        k = min(k, page)
        q, qcodes, w = self.encode_queries(queries, trim, best, weighting)
        _, cand = fp_ops.fused_phase1(self.codes, qcodes, w, page=page)
        return rerank_topk(self.vectors, cand, q, k)

    def gold_topk(self, queries, k: int = 10):
        """Paper's gold standard: brute-force cosine scan over all vectors.
        ``k`` clamps to ``n_docs``."""
        q = normalize(torch.atleast_2d(torch.as_tensor(
            queries, dtype=torch.float32, device=self.device)))
        return brute_force_topk(self.vectors, q, min(k, self.n_docs))
