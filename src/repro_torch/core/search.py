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

The composed engines (the first four) cut their (Q, n_docs) scores to
the page with :func:`select_page`, a stable top-``page``, ties to the
lower doc id as ``jax.lax.top_k`` breaks them (on the card the
``page_select`` kernel, :mod:`repro_torch.kernels.page_select`); the fused
two are page kernels.
:data:`ENGINES` holds what the code branches on for each, and
:func:`phase1` dispatches.  Phase 2 re-ranks the page by exact fp32
cosine (:mod:`repro_torch.core.rerank`) for every engine, the quantized one
included, so reported scores are always exact fp32.

Filtering (trim/best) is query-side, choosable per request, with optional
index-side ``best`` at build time.  The index lives on one device
(``device``, ``"cuda"`` unless the caller asks for the CPU) and makes
every tensor there.

A :class:`PhaseRecorder` closes each phase (encode / phase1 / rescore): a
fenced child of ``search(profile=node)``'s ProfileNode (no fence without
one), and under a timeline sink the span ``search.encode``,
``search.phase1`` or ``search.rescore``, unfenced; on the composed
engines ``search.phase1`` holds ``search.topk`` (:func:`select_page`),
after their own spans (``codes``: ``search.codes.score``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Tuple

import torch

from repro_torch.kernels.page_select import ops as ps_ops
from repro_torch.obs import cost
from repro_torch.obs.tracing import child_clock, phase_clock

from .codes import code_blocks, score_codes, score_onehot
from .encoding import Encoder, RoundingEncoder
from .filtering import (BestFilter, TrimFilter, expand_mask, feature_mask,
                        index_best_codes)
from .postings import (Postings, WalkTally, build_postings, df_lookup,
                       idf_weights, score_postings_batch)
from .quantize import QuantizedTable, quantize_table
from .rerank import brute_force_topk, normalize, rerank_topk

__all__ = ["VectorIndex", "SearchParams", "Engine", "ENGINES",
           "FUSED_ENGINES", "engine_spec", "phase1", "phase1_engine_scores",
           "token_weights", "encode_table", "PhaseRecorder", "select_page",
           "page_rows", "codes_tally"]


@dataclasses.dataclass(frozen=True)
class Engine:
    """What the search path branches on for one phase-1 engine."""

    reads_tokens: bool    # phase 1 reads the query tokens and their weights
    returns_page: bool    # its call is a page kernel: it returns the page
    captured: bool        # SearchGraphs may capture its search


# In the launcher's order.  Only the page kernels are captured: postings
# syncs the host once a batch, and no other composed engine ever was.
ENGINES = {  # name: Engine(reads_tokens, returns_page, captured)
    "codes": Engine(True, False, False),
    "postings": Engine(True, False, False),
    "onehot": Engine(True, False, False),
    "codes_pallas": Engine(True, False, False),
    "fused": Engine(True, True, True),
    "fused_int8": Engine(False, True, True),
}

FUSED_ENGINES = tuple(n for n, e in ENGINES.items() if e.returns_page)


def engine_spec(name: str) -> Engine:
    """The table's record of engine ``name``; ValueError when unknown."""
    spec = ENGINES.get(name)
    if spec is None:
        raise ValueError(f"unknown engine {name!r}")
    return spec


_SENTINEL = {  # never-matching code per dtype (outside any bucket range)
    torch.int8: 127,
    torch.int16: 32767,
    torch.int32: 2**31 - 1,
}

# rows encoded per step at build: the elementwise temporaries of encode
# then stay a few hundred MB at paper scale
_ENCODE_ROWS = 1 << 18


def _cached(obj, key: str, make):
    """``obj.__dict__[key]``, made by ``make()`` at its first read."""
    if key not in obj.__dict__:
        obj.__dict__[key] = make()
    return obj.__dict__[key]


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


class PhaseRecorder:
    """One search's phase boundaries: each closes the ``profile``'s child,
    fenced, then the span under the thread's timeline sink, unfenced."""

    __slots__ = ("profile", "device", "t", "clock")

    def __init__(self, profile, device):
        self.profile, self.device = profile, device
        self.t = time.monotonic() if profile is not None else 0.0
        self.clock = phase_clock()

    def close(self, name: str, span: str, *span_args: int, **attrs):
        """Close profile child ``name`` (with ``attrs``) and span ``span``
        (with ``span_args``) -> the child, or None without a profile."""
        node = (None if self.profile is None
                else self.profile_phase(name, attrs))
        if self.clock is not None:
            self.clock.close(span, *span_args)
        return node

    def profile_phase(self, name: str, attrs: dict):
        """Wait for the device's current stream, where the search runs
        (not the device: another batcher may be capturing a CUDA graph,
        and CUDA forbids a device synchronise then), and add child
        ``name`` timed since the last boundary.  The fence changes when
        the host observes values, never the values."""
        if torch.device(self.device).type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        t0, self.t = self.t, time.monotonic()
        return self.profile.child(name, self.t - t0, **attrs)


def token_weights(weighting: str, mask: torch.Tensor, df,
                  n_docs: int) -> torch.Tensor:
    """(Q, C) weights of the query tokens, 0 where ``mask`` drops one:
    idf of the frequencies ``df()`` over ``n_docs``, or 1 (``count``)."""
    if weighting == "idf":
        w = idf_weights(df(), n_docs)
    elif weighting == "count":
        w = torch.ones(mask.shape, dtype=torch.float32, device=mask.device)
    else:
        raise ValueError(f"unknown weighting {weighting!r}")
    return torch.where(mask, w, 0.0)


def phase1_engine_scores(
    codes: torch.Tensor,           # (d, C) document codes
    postings: Postings,
    qcodes: torch.Tensor,          # (Q, C)
    col_weights: torch.Tensor,     # (Q, C), 0 where the token is filtered
    engine: str,
    max_postings: Optional[int],
    max_abs_bucket: int,
) -> torch.Tensor:
    """Phase-1 scores (Q, d) under one of the composed engines (the
    composed half of :func:`phase1`).  The walk's cost row is filed after
    it, from the entry count its sync read; ``codes`` adds its
    comparisons and doc blocks to :func:`codes_tally`."""
    if engine == "postings":
        with WalkTally() as walk:
            scores = score_postings_batch(
                postings, qcodes, col_weights > 0, max_postings=max_postings,
                weighting="count",   # the weights are folded into col_weights
                col_weights=col_weights)
        cost.record_kernel("score_postings", cost.postings_work(
            walk.entries, qcodes.shape[0], postings.n_docs))
        return scores
    if engine == "codes":
        d, (Q, C) = codes.shape[0], qcodes.shape
        cost.record_kernel("score_codes", cost.codes_work(
            d, Q, C, codes.element_size()))
        _CODES.cells += Q * d * C
        _CODES.blocks += code_blocks(d, Q, C)
        return score_codes(codes, qcodes, col_weights)
    if engine == "codes_pallas":
        from repro_torch.kernels.code_match import ops as cm_ops

        return cm_ops.code_match(codes, qcodes, col_weights)
    if engine == "onehot":
        return score_onehot(codes, qcodes, col_weights, max_abs_bucket)
    raise ValueError(f"unknown engine {engine!r}")


class _PageRows(threading.local):
    rows = 0


_PAGE_ROWS = _PageRows()


def page_rows() -> int:
    """The rows :func:`select_page` has cut on this thread so far; a
    batch's count is the difference across its search."""
    return _PAGE_ROWS.rows


class _CodesTally(threading.local):
    cells = 0
    blocks = 0


_CODES = _CodesTally()


def codes_tally() -> Tuple[int, int]:
    """(comparisons, doc blocks) the ``codes`` engine has made on this
    thread so far: Q·d·C (query, doc, column) comparisons a table scored,
    and the blocks its loop walked; a batch's is the difference across
    its search."""
    return _CODES.cells, _CODES.blocks


def select_page(scores: torch.Tensor, page: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A composed engine's dense (Q, d) phase-1 scores cut to their page ->
    (values, positions int64) (Q, page), ``stable_topk``'s: the
    ``page_select`` kernels on the card, ``stable_topk`` on the CPU.  Files
    the cost row ``page_select`` and adds the Q rows to :func:`page_rows`."""
    Q, d = scores.shape
    cost.record_kernel("page_select", cost.page_select_work(Q, d, page))
    _PAGE_ROWS.rows += Q
    return ps_ops.page_select(scores, page)


def phase1(engine: str, codes, postings, quant, q, qcodes, col_weights,
           page: int, live: Optional[torch.Tensor] = None,
           max_postings: Optional[int] = None, max_abs_bucket: int = 0):
    """Phase 1 of one table (an index, a shard's base, a generation): a
    page kernel -> (scores, ids int32) (Q, page), another engine -> (Q, d)
    scores; rows ``live`` marks False score -inf.  ``quant()`` gives the
    int8 table, read only by the engine that reads no tokens."""
    spec = engine_spec(engine)
    if not spec.returns_page:
        scores = phase1_engine_scores(codes, postings, qcodes, col_weights,
                                      engine, max_postings, max_abs_bucket)
        return (scores if live is None
                else scores.masked_fill(~live[None, :], float("-inf")))
    from repro_torch.kernels.fused_phase1 import ops as fp_ops

    if spec.reads_tokens:
        return fp_ops.fused_phase1(codes, qcodes, col_weights, page=page,
                                   live=live)
    t = quant()
    return fp_ops.fused_phase1_quant(t.codes, t.scale, t.zero, q, page=page,
                                     live=live)


@dataclasses.dataclass(frozen=True)
class SearchParams:
    k: int = 10
    page: int = 320
    trim: Optional[TrimFilter] = None
    best: Optional[BestFilter] = None
    engine: str = "postings"       # a name of ENGINES
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
        """int8 per-row copy of ``vectors`` for ``fused_int8``, derived at
        first use (never stored) and cached: the index is immutable, so
        the cache cannot go stale."""
        return _cached(self, "_quant_cache",
                       lambda: quantize_table(self.vectors))

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
        return q, qcodes, token_weights(
            weighting, mask, lambda: df_lookup(self.postings, qcodes),
            self.postings.n_docs)

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
        spec = engine_spec(engine)
        phases = PhaseRecorder(profile, self.device)
        queries = torch.atleast_2d(torch.as_tensor(
            queries, dtype=torch.float32, device=self.device))
        page = min(page, self.n_docs)
        k = min(k, page)
        q, qcodes, w = (self.encode_queries(queries, trim, best, weighting)
                        if spec.reads_tokens
                        else (normalize(queries), None, None))
        phases.close("encode", "search.encode", n_queries=q.shape[0])
        out = phase1(engine, self.codes, self.postings,
                     lambda: self.quantized, q, qcodes, w, page,
                     max_postings=max_postings,
                     max_abs_bucket=self.encoder.max_abs_bucket)
        if spec.returns_page:
            cand = out[1]
        else:
            sub = child_clock()
            _, cand = select_page(out, page)
            if sub is not None:
                sub.close("search.topk")
        del out
        phases.close("phase1", "search.phase1", 1, 1,  # one shard, one table
                     engine=engine, kernel=engine if spec.returns_page
                     else "composed", page=page, k=k,
                     candidates=cand.numel())
        ids, scores = rerank_topk(self.vectors, cand, q, k)
        phases.close("rescore", "search.rescore", k=k)
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
