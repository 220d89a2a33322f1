"""Public two-phase search API (paper §2.2): VectorIndex.

    idx = VectorIndex.build(vectors, encoder=RoundingEncoder(2))
    ids, sims = idx.search(queries, k=10, page=320, trim=TrimFilter(0.05))

Phase 1 retrieves ``page`` candidates with one of the engines

* ``postings``     -- paper-faithful inverted index
  (:mod:`repro_torch.core.postings`), the default
* ``codes``        -- code-match streaming in plain torch
  (:mod:`repro_torch.core.codes`)
* ``onehot``       -- a float32 matrix product over the one-hot token
  vocabulary
* ``codes_pallas`` -- the code_match kernel (full score matrix;
  :mod:`repro_torch.kernels.code_match`)
* ``fused``        -- the fused kernel: code-match scoring + running
  top-``page`` in one pass, no (Q, n_docs) score matrix
  (:mod:`repro_torch.kernels.fused_phase1`)
* ``fused_int8``   -- the fused kernel over the int8 per-row quantized copy
  of the vectors (:mod:`repro_torch.core.quantize`, derived lazily and
  cached per index instance) -- phase-1 selection only

The composed engines (the first four) select the page with a stable
top-``page`` over their (Q, n_docs) scores, ties to the lower doc id as
``jax.lax.top_k`` breaks them.  Phase 2 re-ranks the page by exact fp32
cosine (:mod:`repro_torch.core.rerank`) for every engine, the quantized one
included, so reported scores are always exact fp32.

Filtering (trim/best) is query-side, choosable per request, with optional
index-side ``best`` at build time.  The index lives on one device
(``device``, ``"cuda"`` unless the caller asks for the CPU) and makes
every tensor there.

``search(profile=node)`` annotates a
:class:`repro_torch.obs.profile.ProfileNode` with encode / phase1 /
rescore children, each phase fenced by :func:`profile_phase`; without a
profile no fence is added.  Under an engine's timeline sink the same
boundaries close the spans ``search.encode``, ``search.phase1`` and
``search.rescore``, unfenced (:func:`repro_torch.obs.tracing.phase_clock`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch

from repro_torch.obs import cost
from repro_torch.obs.tracing import phase_clock

from .codes import score_codes, score_onehot
from .encoding import Encoder, RoundingEncoder
from .filtering import (BestFilter, TrimFilter, expand_mask, feature_mask,
                        index_best_codes)
from .postings import (Postings, build_postings, df_lookup, idf_weights,
                       score_postings_batch)
from .quantize import QuantizedTable, quantize_table
from .rerank import brute_force_topk, normalize, rerank_topk, stable_topk

__all__ = ["VectorIndex", "SearchParams", "phase1_engine_scores",
           "encode_table", "profile_phase", "FUSED_ENGINES"]

# engines that fuse phase-1 scoring with candidate selection: they return
# the candidate page directly instead of a (Q, d) score matrix, so they
# dispatch around phase1_engine_scores
FUSED_ENGINES = ("fused", "fused_int8")

_SENTINEL = {  # never-matching code per dtype (outside any bucket range)
    torch.int8: 127,
    torch.int16: 32767,
    torch.int32: 2**31 - 1,
}

# rows encoded per step at build: the elementwise temporaries of encode
# then stay a few hundred MB at paper scale
_ENCODE_ROWS = 1 << 18


def encode_table(vectors: torch.Tensor, encoder: Encoder,
                 index_best: Optional[int]) -> torch.Tensor:
    """Codes (d, C) of unit rows (d, n), with the index-side best filter's
    sentinel columns, ``_ENCODE_ROWS`` rows a step."""
    parts = []
    for r in range(0, vectors.shape[0], _ENCODE_ROWS):
        rows = vectors[r:r + _ENCODE_ROWS]
        c = encoder.encode(rows)
        if index_best is not None:
            c = index_best_codes(rows, c, index_best, _SENTINEL[c.dtype])
        parts.append(c)
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def profile_phase(profile, name: str, t0: float, device, **attrs) -> float:
    """Close one phase of a profiled search: wait for the work queued on
    ``device``'s current stream, where the search runs (nothing to wait
    for on the CPU), then add child ``name`` to ``profile`` with the wall
    seconds since ``t0`` -> the clock read, the next phase's start.  The
    fence changes when the host observes values, never the values.  It
    waits for the stream, not the whole device: another batcher may be
    capturing a CUDA graph (:mod:`repro_torch.serve.graphs`), and CUDA
    forbids a device synchronise while any stream captures."""
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    t = time.monotonic()
    profile.child(name, t - t0, **attrs)
    return t


def phase1_engine_scores(
    codes: torch.Tensor,           # (d, C) document codes
    postings: Postings,
    qcodes: torch.Tensor,          # (Q, C)
    col_weights: torch.Tensor,     # (Q, C), 0 where the token is filtered
    engine: str,
    max_postings: Optional[int],
    max_abs_bucket: int,
) -> torch.Tensor:
    """Phase-1 scores (Q, d) under one of the composed engines: the single
    engine-dispatch point, so every caller (this index, and later the
    per-shard query phase) gets every engine."""
    if engine == "postings":
        return score_postings_batch(
            postings, qcodes, col_weights > 0, max_postings=max_postings,
            weighting="count",   # the weights are folded into col_weights
            col_weights=col_weights)
    if engine == "codes":
        cost.record_kernel("score_codes", cost.codes_work(
            codes.shape[0], qcodes.shape[0], qcodes.shape[1],
            codes.element_size()))
        return score_codes(codes, qcodes, col_weights)
    if engine == "codes_pallas":
        from repro_torch.kernels.code_match import ops as cm_ops

        return cm_ops.code_match(codes, qcodes, col_weights)
    if engine == "onehot":
        return score_onehot(codes, qcodes, col_weights, max_abs_bucket)
    raise ValueError(f"unknown engine {engine!r}")


@dataclasses.dataclass(frozen=True)
class SearchParams:
    k: int = 10
    page: int = 320
    trim: Optional[TrimFilter] = None
    best: Optional[BestFilter] = None
    engine: str = "postings"  # postings|codes|onehot|codes_pallas|fused|fused_int8
    weighting: str = "idf"         # idf | count
    max_postings: Optional[int] = None  # None -> exact (= n_docs)


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
        codes = encode_table(vectors, encoder, index_best)
        return cls(vectors, codes, build_postings(codes), encoder, index_best)

    @property
    def n_docs(self) -> int:
        return self.vectors.shape[0]

    @property
    def n_features(self) -> int:
        return self.vectors.shape[1]

    @property
    def quantized(self) -> QuantizedTable:
        """int8 per-row quantized copy of ``vectors`` for ``fused_int8``
        phase-1 selection.  Derived at first use (a pure function of the
        vector bits, never stored) and cached on this instance: the index
        is immutable, so the cache cannot go stale."""
        cached = self.__dict__.get("_quant_cache")
        if cached is None:
            cached = quantize_table(self.vectors)
            self.__dict__["_quant_cache"] = cached
        return cached

    def resident_leaves(self):
        """``(path, section, tensor)`` of the tables this index holds,
        under the paths the JAX package's tree walk gives its flat index
        (the lazy int8 table left out, as that walk leaves it out)."""
        yield "[<flat index 0>]", "index", self.vectors
        yield "[<flat index 1>]", "index", self.codes
        if self.postings is not None:
            yield ("[<flat index 2>].post_docs", "index",
                   self.postings.post_docs)
            yield ("[<flat index 2>].post_codes", "index",
                   self.postings.post_codes)

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

    # ----------------------------------------------------------------- phase 1
    def phase1_scores(
        self,
        qcodes: torch.Tensor,
        col_weights: torch.Tensor,
        engine: str,
        max_postings: Optional[int],
    ) -> torch.Tensor:
        return phase1_engine_scores(
            self.codes, self.postings, qcodes, col_weights, engine,
            max_postings, self.encoder.max_abs_bucket)

    # ------------------------------------------------------------------ search
    def search(
        self,
        queries,
        k: int = 10,
        page: int = 320,
        trim: Optional[TrimFilter] = None,
        best: Optional[BestFilter] = None,
        engine: str = "postings",
        weighting: str = "idf",
        max_postings: Optional[int] = None,
        profile=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Two-phase search -> (ids (Q,k) int32, cosine scores (Q,k) f32),
        on the index's device.

        ``fused`` selects exactly what ``codes`` selects, without the score
        matrix; ``fused_int8`` trades candidate recall for a quarter of
        the phase-1 bytes, and reads no tokens, so trim, best and
        weighting do not apply to it.  ``max_postings`` caps every posting
        list the ``postings`` engine walks (None: exact).

        ``profile`` is an optional
        :class:`repro_torch.obs.profile.ProfileNode` that receives encode /
        phase1 / rescore children with host wall times (the JAX package's
        names and attributes; ``kernel`` is the engine for the fused
        engines, else ``"composed"``)."""
        t_prof = time.monotonic() if profile is not None else 0.0
        clock = phase_clock()
        queries = torch.atleast_2d(torch.as_tensor(
            queries, dtype=torch.float32, device=self.device))
        page = min(page, self.n_docs)
        k = min(k, page)
        if engine == "fused_int8":
            from repro_torch.kernels.fused_phase1 import ops as fp_ops

            q = normalize(queries)
            if profile is not None:
                t_prof = profile_phase(profile, "encode", t_prof,
                                       self.device, n_queries=q.shape[0])
            if clock is not None:
                clock.close("search.encode")
            qt = self.quantized
            _, cand = fp_ops.fused_phase1_quant(qt.codes, qt.scale, qt.zero,
                                                q, page=page)
        else:
            q, qcodes, w = self.encode_queries(queries, trim, best,
                                               weighting)
            if profile is not None:
                t_prof = profile_phase(profile, "encode", t_prof,
                                       self.device, n_queries=q.shape[0])
            if clock is not None:
                clock.close("search.encode")
            if engine == "fused":
                from repro_torch.kernels.fused_phase1 import ops as fp_ops

                _, cand = fp_ops.fused_phase1(self.codes, qcodes, w,
                                              page=page)
            else:
                scores1 = self.phase1_scores(qcodes, w, engine, max_postings)
                _, cand = stable_topk(scores1, page)
                del scores1
        if profile is not None:
            t_prof = profile_phase(
                profile, "phase1", t_prof, self.device, engine=engine,
                kernel=engine if engine in FUSED_ENGINES else "composed",
                page=page, k=k, candidates=cand.numel())
        if clock is not None:
            clock.close("search.phase1", 1, 1)     # one shard, one table
        ids, scores = rerank_topk(self.vectors, cand, q, k)
        if profile is not None:
            profile_phase(profile, "rescore", t_prof, self.device, k=k)
        if clock is not None:
            clock.close("search.rescore")
        return ids, scores

    def shard(self, mesh=None, **kwargs):
        """This index split over ``mesh``'s doc-shards and replica groups
        (one shard by default) as a
        :class:`repro_torch.dist.shard_index.ShardedVectorIndex` on this
        index's device, viewing its tensors where the rows split evenly:
        the same ``search`` contract, plus ingest, delete, segment merges
        and compaction (``kwargs``: ``seal_threshold``)."""
        from repro_torch.dist.shard_index import ShardedVectorIndex

        return ShardedVectorIndex.from_index(self, mesh=mesh, **kwargs)

    def gold_topk(self, queries, k: int = 10):
        """Paper's gold standard: brute-force cosine scan over all vectors.
        ``k`` clamps to ``n_docs``."""
        q = normalize(torch.atleast_2d(torch.as_tensor(
            queries, dtype=torch.float32, device=self.device)))
        return brute_force_topk(self.vectors, q, min(k, self.n_docs))
