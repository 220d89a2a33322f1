"""Doc-sharded two-phase search with the segment lifecycle, S shards x R
replica groups on one device.

:class:`ShardedVectorIndex` is the reference's doc-sharded index: its
tensors keep the leading shard axis (``vectors (S, dp, n)``, ``codes (S,
dp, C)``, ``post_docs`` / ``post_codes (S, C, dp)``, ``offsets (S,)``,
``live (S, dp)``, ``seg_* (S, G, ...)``) and shard ``s`` holds the
contiguous id range ``[offsets[s], offsets[s] + dp)``; a ragged tail is
padded with zero rows, sentinel codes and ``live=False``.  The layout is a
:class:`repro_torch.launch.mesh.ShardMesh` (``mesh=``): S doc-shards along
``data`` and R replica groups along ``replica``, every cell on one device,
so a shard is a slice of one tensor and the R groups share every tensor.
``device=`` alone is the one-shard, one-group mesh on that device
(``"cuda"`` unless the caller asks for the CPU).

A query runs the reference's query/fetch protocol:

1. **query phase**, per shard: phase 1 over the shard's base and its
   column of every generation, with idf weights from the document
   frequencies summed over the shards (integer-exact, over the global
   ``n_ids``); the shard's stable top-``page``, the page's exact cosines
   (:func:`repro_torch.core.rerank.tree_dot`) and its ids made global;
2. **merge phase**: ``merge="gather"`` joins the shard pages shard-major
   and takes one stable top-``k``; ``merge="stream"`` folds the pages in
   shard order into a running stable top-``k`` over ``[acc | page]``, so
   at most ``k + page`` candidates a query are held.  Both keep the lower
   shard (then the lower page slot) on ties, so they return the same bits.
   The hits are then rescored unsharded, at the ``(Q, k, n)`` shape.

**Replica groups.**  A batch is zero-padded to ``U * B`` rows for the
``U`` live groups and row-block ``j`` runs the query phase on group
``groups[j]``; pad rows are dropped before the rescore, whose shape they
would change.  ``search(live_groups=...)`` serves from the named groups
only (the failover path), and :meth:`replica_group` views one group as a
one-group index sharing the tensors: the unit a router batches.

**The segment story.**

* :meth:`add_documents` appends to an *active buffer*: ids continue from
  :attr:`n_ids`, capacity grows geometrically (``max(need, 2G, 8)``).
  Once the buffer holds ``seal_threshold`` rows it *seals* into an
  immutable :class:`Segment`, truncated to its exact width and given its
  own posting table for df lookups.
* :meth:`delete` tombstones ids in the base, the sealed segments and the
  active buffer: ``live`` goes False, the codes become the sentinel, and
  every touched posting table is rebuilt, so document frequencies count
  live docs only.  ``live`` alone decides whether a row may be a result.
* :meth:`merge_segments` folds a contiguous run of sealed segments into
  one, dropping its tombstones; :meth:`compact` rebuilds the base over
  the live table with stable ids.
* Every mutation returns a new index sharing unchanged tensors.  With
  ``add_documents(..., donate=True)`` a batch that fits the active buffer
  is written into its tensors in place: the old index shares them and
  must not be used again (the serving engine donates only when no batch
  in flight holds the index).

**Per shard**, phase 1 scores the base, then each generation (sealed
segments oldest first, then the active buffer), and keeps the top ``page``
of the joined positions ``[base | generations... | active]`` by a stable
selection (the order of append, so ties go to the lower id).  Sealing and
sharding must be invisible: a row has to score the
same bits in a 4,096-row segment as in a 65,536-row flat buffer, and in a
shard as in the whole table.  So every generation is scored by a function
whose per-row bits do not depend on the table's width:

* the composed engines score generations with ``code_match``, whose sums
  run in an order fixed by C alone (on the card the kernel; on the CPU
  its plain version, one ``sum`` per row);
* the page kernels score each with their own kernel at its top page:
  ``fused_phase1`` sums in ``code_match``'s tree on the card, and
  ``fused_phase1_quant`` exactly in integers with a fixed combine;
* the page is re-ranked with :func:`repro_torch.core.rerank.tree_dot`, and
  the final ``(Q, k, n)`` rescore is the einsum of
  :func:`repro_torch.core.rerank.exact_scores`.

A segmented index and a flat one (``seal_threshold=None``) given the same
history return the same ids and scores bit for bit; at ``page >= n_ids``
so do S shards and one, for every engine.  Result slots that no
live doc can fill report ``(id=-1, score=-inf)``.  idf weighting uses
``N = n_ids`` (every id ever assigned, Elasticsearch's ``maxDoc``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.encoding import Encoder, RoundingEncoder
from repro_torch.core.filtering import (BestFilter, TrimFilter, expand_mask,
                                        feature_mask, index_best_codes)
from repro_torch.core.postings import (Postings, build_postings, code_df,
                                       df_lookup)
from repro_torch.core.quantize import QuantizedTable, quantize_table
from repro_torch.core.rerank import (check_fp32_matmul, normalize,
                                     stable_topk, tree_dot)
from repro_torch.core.search import (_SENTINEL, PhaseRecorder, VectorIndex,
                                     _cached,
                                     encode_table, engine_spec, phase1,
                                     token_weights)
from repro_torch.obs.compile_watch import watch_region
from repro_torch.obs.tracing import phase_clock

__all__ = ["ShardedVectorIndex", "Segment", "DEFAULT_SEAL_THRESHOLD"]

# The active buffer seals into a Segment once it holds this many rows.
# None disables sealing: the flat append path the parity tests pin against.
DEFAULT_SEAL_THRESHOLD = 256

# posting columns scanned per step by max_df: a (32, d) bool temporary
_DF_COLUMNS = 32

_NEG_INF = float("-inf")

Quant = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _quantize(vectors: torch.Tensor) -> Quant:
    """(codes (S, W, n) int8, scale (S, W), zero (S, W)) of (S, W, n) rows:
    the quantization is row-wise, so the whole table at once."""
    ns, w, n = vectors.shape
    t = quantize_table(vectors.reshape(ns * w, n))
    return (t.codes.view(ns, w, n), t.scale.view(ns, w),
            t.zero.view(ns, w))


def _postings(codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (S, C, W) posting tables of (S, W, C) codes, each shard's sorted
    into its slice."""
    ns, w, n_cols = codes.shape
    pdocs = torch.empty((ns, n_cols, w), dtype=torch.int32,
                        device=codes.device)
    pcodes = torch.empty((ns, n_cols, w), dtype=codes.dtype,
                         device=codes.device)
    for s in range(ns):
        build_postings(codes[s], out=(pdocs[s], pcodes[s]))
    return pdocs, pcodes


def resolve_mesh(mesh, device) -> "ShardMesh":
    """The layout an entry point builds on: ``mesh``, or the one-shard
    mesh on ``device`` (the card when neither is given)."""
    from repro_torch.launch.mesh import make_shard_mesh

    if mesh is not None and device is not None:
        raise ValueError("pass mesh= or device=, not both")
    if mesh is None:
        mesh = make_shard_mesh(1, device="cuda" if device is None else device)
    mesh.device                 # raises for a grid over several devices
    return mesh


def _same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _partition(n: int, ns: int) -> Tuple[int, int]:
    """(docs per shard, pad rows) of ``n`` docs over ``ns`` contiguous
    shards."""
    if ns > n:
        raise ValueError(f"more shards ({ns}) than documents ({n})")
    dp = -(-n // ns)
    return dp, ns * dp - n


def _offsets(ns: int, dp: int, device) -> torch.Tensor:
    return torch.arange(ns, dtype=torch.int32, device=device) * dp


@dataclasses.dataclass
class Segment:
    """One immutable sealed generation of appended docs.

    Rows are round-robin over the shards, at the exact width of the
    fullest shard; the per-shard mini posting tables answer
    df lookups.  The only changes are tombstones (through
    :meth:`ShardedVectorIndex.delete`, which returns a new Segment with
    rebuilt postings) and replacement by a merge.  ``n_rows`` and
    ``tombstones`` are host ints."""

    vectors: torch.Tensor     # (S, G, n) f32 unit rows; zero rows pad
    codes: torch.Tensor       # (S, G, C) int; sentinel = dead or padding
    gids: torch.Tensor        # (S, G) int32 global ids; -1 = padding
    live: torch.Tensor        # (S, G) bool
    post_docs: torch.Tensor   # (S, C, G) int32
    post_codes: torch.Tensor  # (S, C, G)
    n_rows: int               # rows holding a doc, live or tombstoned
    tombstones: int           # dead rows among n_rows

    @property
    def width(self) -> int:
        return self.vectors.shape[1]

    @property
    def deleted_ratio(self) -> float:
        return self.tombstones / max(self.n_rows, 1)

    def quantized(self) -> Quant:
        """The int8 per-row table of this segment's vectors for
        ``fused_int8``, derived at first use and cached (tombstones keep
        the vectors, so :meth:`ShardedVectorIndex.delete` carries it)."""
        return _cached(self, "_quant_cache", lambda: _quantize(self.vectors))


@dataclasses.dataclass
class ShardedVectorIndex:
    """:class:`VectorIndex` split into doc-shards, plus segments and
    tombstones, on a :class:`~repro_torch.launch.mesh.ShardMesh`."""

    vectors: torch.Tensor      # (S, dp, n) f32 unit rows; zero rows pad
    codes: torch.Tensor        # (S, dp, C) int; sentinel = pad or tombstone
    post_docs: torch.Tensor    # (S, C, dp) int32
    post_codes: torch.Tensor   # (S, C, dp)
    offsets: torch.Tensor      # (S,) int32 global id of each shard's doc 0
    live: torch.Tensor         # (S, dp) bool; False = pad or tombstone
    seg_vectors: torch.Tensor  # (S, G, n) f32 active buffer
    seg_codes: torch.Tensor    # (S, G, C) int; sentinel = empty or dead
    seg_gids: torch.Tensor     # (S, G) int32; -1 = never used
    seg_live: torch.Tensor     # (S, G) bool
    segments: Tuple[Segment, ...]   # sealed generations, oldest first
    encoder: Encoder
    n_docs: int                # base id-space size
    index_best: Optional[int]
    n_appended: int = 0        # docs appended since the last compact
    shard_tombstones: Tuple[int, ...] = ()   # deletes not yet reclaimed
    seal_threshold: Optional[int] = DEFAULT_SEAL_THRESHOLD
    seg_base: int = 0          # append count at the active buffer's start
    active_tombstones: int = 0  # dead rows in the active buffer
    mesh: Optional["ShardMesh"] = None   # None: one shard, one group

    def __post_init__(self):
        if self.mesh is None:
            self.mesh = resolve_mesh(None, self.vectors.device)
        if self.mesh.n_shards != self.vectors.shape[0]:
            raise ValueError(f"{self.vectors.shape[0]} shards on a mesh of "
                             f"{self.mesh.n_shards}")

    # ------------------------------------------------------------ properties
    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def n_shards(self) -> int:
        return self.vectors.shape[0]

    @property
    def n_replicas(self) -> int:
        return self.mesh.n_replicas

    @property
    def docs_per_shard(self) -> int:
        return self.vectors.shape[1]

    @property
    def n_features(self) -> int:
        return self.vectors.shape[2]

    @property
    def seg_capacity(self) -> int:
        """Active-buffer slots per shard (0: no open buffer)."""
        return self.seg_vectors.shape[1]

    @property
    def n_ids(self) -> int:
        """Global id-space size: base docs + docs ever appended."""
        return self.n_docs + self.n_appended

    @property
    def n_tombstones(self) -> int:
        return sum(self.shard_tombstones)

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def n_active(self) -> int:
        """Docs in the active (unsealed) buffer."""
        return self.n_appended - self.seg_base

    @property
    def segment_rows(self) -> int:
        """Rows held by sealed segments, tombstoned rows included."""
        return sum(s.n_rows for s in self.segments)

    @property
    def n_reclaimed(self) -> int:
        """Appended rows dropped by segment merges since the last compact."""
        return self.n_appended - self.n_active - self.segment_rows

    @staticmethod
    def _seg_slots_used(n_appended: int, ns: int) -> np.ndarray:
        """(S,) append slots used per shard: the round-robin occupancy that
        routing and tombstone accounting share."""
        used = np.full(ns, n_appended // ns, np.int64)
        used[: n_appended % ns] += 1
        return used

    @property
    def shard_populations(self) -> np.ndarray:
        """(S,) docs ever assigned to each shard (base + appended)."""
        ns, dp = self.n_shards, self.docs_per_shard
        base = np.clip(self.n_docs - np.arange(ns) * dp, 0, dp)
        app = self._seg_slots_used(self.n_active, ns)
        for s in self.segments:
            app = app + self._seg_slots_used(s.n_rows, ns)
        return base + app

    @property
    def tombstone_ratio(self) -> float:
        """Worst per-shard dead fraction (deleted / docs ever assigned)."""
        if not any(self.shard_tombstones):
            return 0.0
        dead = np.asarray(self.shard_tombstones, np.float64)
        return float(np.max(dead / np.maximum(self.shard_populations, 1)))

    @property
    def max_df(self) -> int:
        """Longest live posting list over every shard and column: the exact
        per-shard ``max_postings`` window, cached (mutations make new
        instances)."""
        sentinel = _SENTINEL[self.codes.dtype]
        return _cached(self, "_max_df_cache", lambda: max(
            _max_df(pc, sentinel) for pc in self.post_codes))

    # ------------------------------------------------------ quantized tables
    # int8 per-row copies of the vectors for fused_int8, derived at first
    # use and cached per instance.  Tombstones change no vector, so the
    # mutation paths carry them wherever the vectors are shared.
    def _quant_base(self) -> Quant:
        return _cached(self, "_quant_base_cache",
                       lambda: _quantize(self.vectors))

    def _quant_active(self) -> Quant:
        return _cached(self, "_quant_active_cache",
                       lambda: _quantize(self.seg_vectors))

    def _carry_quant(self, out: "ShardedVectorIndex", base: bool = False,
                     active: bool = False) -> "ShardedVectorIndex":
        """Give ``out`` this index's quant tables of the vectors it shares
        (``dataclasses.replace`` drops them)."""
        for flag, key in ((base, "_quant_base_cache"),
                          (active, "_quant_active_cache")):
            if flag and key in self.__dict__:
                out.__dict__[key] = self.__dict__[key]
        return out

    # -------------------------------------------------------- obs: residency
    def resident_leaves(self):
        """``(path, section, tensor)`` for every tensor this index holds,
        under the JAX package's paths -- the seam
        :func:`repro_torch.obs.device.device_bytes` walks.  It includes
        the lazily derived quant tables (``_quant_base_cache``,
        ``_quant_active_cache``, each segment's ``_quant_cache``), which
        are real residents but not dataclass fields."""
        yield "vectors", "base", self.vectors
        yield "codes", "base", self.codes
        yield "post_docs", "base", self.post_docs
        yield "post_codes", "base", self.post_codes
        yield "offsets", "base", self.offsets
        yield "live", "base", self.live
        yield "seg_vectors", "active", self.seg_vectors
        yield "seg_codes", "active", self.seg_codes
        yield "seg_gids", "active", self.seg_gids
        yield "seg_live", "active", self.seg_live
        for i, seg in enumerate(self.segments):
            for nm in ("vectors", "codes", "gids", "live",
                       "post_docs", "post_codes"):
                yield f"segments[{i}].{nm}", "segments", getattr(seg, nm)
            q = seg.__dict__.get("_quant_cache")
            if q is not None:
                for nm, t in zip(("codes", "scale", "zero"), q):
                    yield f"segments[{i}].quant.{nm}", "quant", t
        for key, prefix in (("_quant_base_cache", "quant.base"),
                            ("_quant_active_cache", "quant.active")):
            q = self.__dict__.get(key)
            if q is not None:
                for nm, t in zip(("codes", "scale", "zero"), q):
                    yield f"{prefix}.{nm}", "quant", t

    # ------------------------------------------------------------- replicas
    def replica_group(self, g: int) -> "ShardedVectorIndex":
        """Replica group ``g`` as a one-group index over the same tensors
        (and derived tables): the unit a router fronts with its own
        batcher, searched, mutated and compacted on its own."""
        R = self.n_replicas
        if not 0 <= g < R:
            raise ValueError(f"replica group must be in [0, {R}), got {g}")
        if R == 1:
            return self
        out = dataclasses.replace(self, mesh=self.mesh.column(g))
        if "_max_df_cache" in self.__dict__:
            out.__dict__["_max_df_cache"] = self.__dict__["_max_df_cache"]
        return self._carry_quant(out, base=True, active=True)

    # --------------------------------------------------------- introspection
    def token_df(self, queries) -> torch.Tensor:
        """Per-token document frequencies (Q, C) int32, exactly what the
        idf weighting of :meth:`search` sees: live docs only."""
        q = normalize(torch.atleast_2d(torch.as_tensor(
            queries, dtype=torch.float32, device=self.device)))
        return self._df(self.encoder.encode(q))

    def _df(self, qcodes: torch.Tensor) -> torch.Tensor:
        """Live document frequencies summed over the shards, integer-exact:
        the base's and each sealed segment's posting tables, and the active
        buffer's codes."""
        df = _shards_df(self.post_docs, self.post_codes, qcodes)
        for seg in self.segments:
            # sealed generations answer off their mini posting tables
            df = df + _shards_df(seg.post_docs, seg.post_codes, qcodes)
        if self.seg_capacity:
            df = df + code_df(self.seg_codes.reshape(-1, qcodes.shape[-1]),
                              qcodes)
        return df

    # ----------------------------------------------------------------- build
    @classmethod
    def _empty_active(cls, ns: int, n_feat: int, n_cols: int, code_dtype,
                      device) -> dict:
        """The ``seg_*`` tensors of an empty active buffer over ``ns``
        shards."""
        return {
            "seg_vectors": torch.zeros((ns, 0, n_feat), device=device),
            "seg_codes": torch.full((ns, 0, n_cols), _SENTINEL[code_dtype],
                                    dtype=code_dtype, device=device),
            "seg_gids": torch.full((ns, 0), -1, dtype=torch.int32,
                                   device=device),
            "seg_live": torch.zeros((ns, 0), dtype=torch.bool,
                                    device=device)}

    @classmethod
    def build_sharded(
        cls,
        vectors,
        encoder: Encoder = RoundingEncoder(2),
        index_best: Optional[int] = None,
        *,
        live=None,
        seal_threshold: Optional[int] = DEFAULT_SEAL_THRESHOLD,
        mesh=None,
        device=None,
    ) -> "ShardedVectorIndex":
        """Normalize -> encode -> ``index_best`` masking -> per-shard
        posting tables, on ``mesh`` (or the one-shard mesh on ``device``).
        Rows split into contiguous shards, the last padded.  ``live=False``
        rows (how :meth:`compact` carries tombstones) become zero vectors
        with sentinel codes."""
        mesh = resolve_mesh(mesh, device)
        dev = mesh.device
        v = torch.as_tensor(vectors, dtype=torch.float32, device=dev)
        if v.ndim != 2:
            raise ValueError(
                f"vectors must be 2-D, got shape {tuple(v.shape)}")
        n, n_feat = v.shape
        ns = mesh.n_shards
        dp, pad = _partition(n, ns)
        lv = (torch.ones((n,), dtype=torch.bool, device=dev) if live is None
              else torch.as_tensor(live, dtype=torch.bool, device=dev))
        v = normalize(v)
        if pad:
            v = torch.cat([v, torch.zeros((pad, n_feat), device=dev)])
            lv = torch.cat([lv, torch.zeros((pad,), dtype=torch.bool,
                                            device=dev)])
        v.masked_fill_(~lv[:, None], 0.0)
        with watch_region("build.program", sig=(ns, dp, n_feat)):
            codes = encode_table(v, encoder, index_best)
            codes.masked_fill_(~lv[:, None], _SENTINEL[codes.dtype])
            codes = codes.view(ns, dp, -1)
            pdocs, pcodes = _postings(codes)
        return cls(vectors=v.view(ns, dp, n_feat), codes=codes,
                   post_docs=pdocs, post_codes=pcodes,
                   offsets=_offsets(ns, dp, dev), live=lv.view(ns, dp),
                   encoder=encoder, n_docs=n, index_best=index_best,
                   seal_threshold=seal_threshold, segments=(), mesh=mesh,
                   **cls._empty_active(ns, n_feat, codes.shape[-1],
                                       codes.dtype, dev))

    @classmethod
    def from_index(cls, index: VectorIndex, *,
                   seal_threshold: Optional[int] = DEFAULT_SEAL_THRESHOLD,
                   mesh=None) -> "ShardedVectorIndex":
        """``index`` split over ``mesh``'s shards (one shard by default),
        on the index's device.  The vectors, codes and int8 table (when
        the index has one) are views of the index's wherever ``n_docs``
        divides by the shard count (padded copies otherwise); at one shard
        the posting tables are the index's, at S they are rebuilt per
        shard.  Replica groups share every tensor."""
        dev = index.device
        mesh = resolve_mesh(mesh, None if mesh is not None else dev)
        if not _same_device(mesh.device, dev):
            raise ValueError(f"the index is on {dev}, the mesh on "
                             f"{mesh.device}")
        n, n_feat, ns = index.n_docs, index.n_features, mesh.n_shards
        dp, pad = _partition(n, ns)
        vectors, codes = index.vectors, index.codes
        if pad:
            vectors = torch.cat([vectors, vectors.new_zeros((pad, n_feat))])
            codes = torch.cat([codes, codes.new_full(
                (pad, codes.shape[1]), _SENTINEL[codes.dtype])])
        codes = codes.view(ns, dp, -1)
        if ns == 1:
            pdocs = index.postings.post_docs[None]
            pcodes = index.postings.post_codes[None]
        else:
            with watch_region("build.postings", sig=tuple(codes.shape)):
                pdocs, pcodes = _postings(codes)
        live = (torch.arange(dp, device=dev)[None, :]
                < (n - torch.arange(ns, device=dev) * dp)[:, None])
        out = cls(vectors=vectors.view(ns, dp, n_feat), codes=codes,
                  post_docs=pdocs, post_codes=pcodes,
                  offsets=_offsets(ns, dp, dev), live=live,
                  encoder=index.encoder, n_docs=n,
                  index_best=index.index_best, seal_threshold=seal_threshold,
                  segments=(), mesh=mesh, **cls._empty_active(
                      ns, n_feat, codes.shape[-1], codes.dtype, dev))
        qt = index.__dict__.get("_quant_cache")
        if qt is not None and not pad:
            out.__dict__["_quant_base_cache"] = (
                qt.codes.view(ns, dp, n_feat), qt.scale.view(ns, dp),
                qt.zero.view(ns, dp))
        return out

    @classmethod
    def build(cls, vectors, encoder=None, index_best=None, device=None,
              mesh=None):
        """:meth:`build_sharded` with the default encoder unless one is
        given."""
        kwargs = {} if encoder is None else {"encoder": encoder}
        return cls.build_sharded(vectors, index_best=index_best,
                                 device=device, mesh=mesh, **kwargs)

    # ---------------------------------------------------------------- ingest
    def add_documents(self, vectors, *,
                      donate: bool = False) -> "ShardedVectorIndex":
        """Append documents -> a new index sharing every unchanged tensor.

        Rows are normalized, encoded and ``index_best``-masked, routed
        round-robin into the active buffer with ids from :attr:`n_ids`.
        The buffer grows to ``max(need, 2G, 8)`` slots when full, and seals
        at ``seal_threshold`` rows.  ``donate=True`` writes a batch that
        fits into the buffer's own tensors, allocating nothing: ``self``
        then shares the written tensors and must not be used again.  A
        batch that grows the buffer writes into new tensors either way."""
        v = torch.atleast_2d(torch.as_tensor(vectors, dtype=torch.float32,
                                             device=self.device))
        m = int(v.shape[0])
        if m == 0:
            return self
        if v.shape[1] != self.n_features:
            raise ValueError(f"expected {self.n_features}-feature vectors, "
                             f"got {tuple(v.shape)}")
        v = normalize(v)
        codes = self.encoder.encode(v)
        sentinel = _SENTINEL[self.codes.dtype]
        if self.index_best is not None:
            codes = index_best_codes(v, codes, self.index_best, sentinel)

        ns, G = self.n_shards, self.seg_capacity
        # round-robin on the active buffer's own counter: slot use is a
        # pure function of the append history (tombstones keep their slot)
        n_act = self.n_active
        used = self._seg_slots_used(n_act, ns)
        shard_of = (n_act + np.arange(m)) % ns
        slot_of = used[shard_of] + np.arange(m) // ns
        need = int(slot_of.max()) + 1
        gids = torch.arange(self.n_ids, self.n_ids + m, dtype=torch.int32,
                            device=self.device)

        svec, scod = self.seg_vectors, self.seg_codes
        sgid, sliv = self.seg_gids, self.seg_live
        if need > G:
            # geometric growth bounds the copies of an ingest stream to
            # O(log(appended)); spare slots are sentinel-coded and dead
            grow = max(need, 2 * G, 8) - G
            dev, C = self.device, scod.shape[-1]
            svec = torch.cat([svec, torch.zeros((ns, grow, self.n_features),
                                                device=dev)], dim=1)
            scod = torch.cat([scod, torch.full((ns, grow, C), sentinel,
                                               dtype=scod.dtype,
                                               device=dev)], dim=1)
            sgid = torch.cat([sgid, torch.full((ns, grow), -1,
                                               dtype=torch.int32,
                                               device=dev)], dim=1)
            sliv = torch.cat([sliv, torch.zeros((ns, grow), dtype=torch.bool,
                                                device=dev)], dim=1)
        elif not donate:
            svec, scod, sgid, sliv = (t.clone()
                                      for t in (svec, scod, sgid, sliv))
        sh = torch.as_tensor(shard_of, device=self.device)
        sl = torch.as_tensor(slot_of, device=self.device)
        with watch_region("ingest.append",
                          sig=(m, int(svec.shape[1]), need > G)):
            svec[sh, sl] = v
            scod[sh, sl] = codes.to(scod.dtype)
            sgid[sh, sl] = gids
            sliv[sh, sl] = True
        out = dataclasses.replace(
            self, seg_vectors=svec, seg_codes=scod, seg_gids=sgid,
            seg_live=sliv, n_appended=self.n_appended + m)
        out = self._carry_quant(out, base=True)
        if (out.seal_threshold is not None
                and out.n_active >= out.seal_threshold):
            out = out._seal_active()
        return out

    def _seal_active(self) -> "ShardedVectorIndex":
        """Seal the active buffer into a :class:`Segment` of its exact
        width with its own posting table; a fresh buffer opens."""
        n_act = self.n_active
        if n_act == 0:
            return self
        clock = phase_clock()
        w = int(self._seg_slots_used(n_act, self.n_shards).max())
        svec, scod, sgid, sliv = (t[:, :w].clone() for t in (
            self.seg_vectors, self.seg_codes, self.seg_gids, self.seg_live))
        with watch_region("ingest.seal", sig=(w, self.n_shards)):
            pdocs, pcodes = _postings(scod)
        seg = Segment(svec, scod, sgid, sliv, pdocs, pcodes, n_rows=n_act,
                      tombstones=self.active_tombstones)
        out = dataclasses.replace(
            self, segments=self.segments + (seg,), seg_base=self.n_appended,
            active_tombstones=0, **self._empty_active(
                self.n_shards, self.n_features, self.codes.shape[-1],
                self.codes.dtype, self.device))
        out = self._carry_quant(out, base=True)
        if clock is not None:
            clock.close("ingest.seal")
        return out

    def delete(self, ids) -> "ShardedVectorIndex":
        """Tombstone documents by global id -> a new index.

        ``live`` goes False and the codes become the sentinel; the base's
        and each touched segment's posting tables are rebuilt, so df
        counts live docs only.  An id already dead is a no-op for that id
        and is not counted again."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        if ids.size == 0:
            return self
        if (ids < 0).any() or (ids >= self.n_ids).any():
            raise ValueError(f"ids must be in [0, {self.n_ids}), got "
                             f"{ids.min()}..{ids.max()}")
        sentinel = _SENTINEL[self.codes.dtype]
        dev = self.device
        dead = np.zeros(self.n_shards, np.int64)
        new = {}

        def tombstone(codes, live, s, r):
            """-> (codes, live, was_live): copies with rows (s, r) dead."""
            s, r = torch.as_tensor(s, device=dev), torch.as_tensor(r,
                                                                   device=dev)
            was_live = live[s, r].cpu().numpy()
            codes, live = codes.clone(), live.clone()
            codes[s, r] = sentinel
            live[s, r] = False
            return codes, live, was_live

        base = ids[ids < self.n_docs]
        if base.size:
            s, r = np.divmod(base, self.docs_per_shard)
            codes, live, was_live = tombstone(self.codes, self.live, s, r)
            np.add.at(dead, s[was_live], 1)
            new["codes"], new["live"] = codes, live
            new["post_docs"], new["post_codes"] = _postings(codes)
        app = ids[ids >= self.n_docs]
        if app.size:
            segs, changed = list(self.segments), False
            for i, seg in enumerate(segs):
                s, g = np.nonzero(np.isin(seg.gids.cpu().numpy(), app))
                if s.size == 0:
                    continue
                codes, live, was_live = tombstone(seg.codes, seg.live, s, g)
                np.add.at(dead, s[was_live], 1)
                segs[i] = Segment(seg.vectors, codes, seg.gids, live,
                                  *_postings(codes), seg.n_rows,
                                  seg.tombstones + int(was_live.sum()))
                if "_quant_cache" in seg.__dict__:
                    segs[i].__dict__["_quant_cache"] = \
                        seg.__dict__["_quant_cache"]
                changed = True
            if changed:
                new["segments"] = tuple(segs)
            s, g = np.nonzero(np.isin(self.seg_gids.cpu().numpy(), app))
            if s.size:
                codes, live, was_live = tombstone(self.seg_codes,
                                                  self.seg_live, s, g)
                np.add.at(dead, s[was_live], 1)
                new["seg_codes"], new["seg_live"] = codes, live
                new["active_tombstones"] = (self.active_tombstones
                                            + int(was_live.sum()))
        old = (np.asarray(self.shard_tombstones, np.int64)
               if self.shard_tombstones else np.zeros(self.n_shards, np.int64))
        new["shard_tombstones"] = tuple(int(x) for x in old + dead)
        # no vector changed: every quant table stays valid
        return self._carry_quant(dataclasses.replace(self, **new),
                                 base=True, active=True)

    def compact(self) -> "ShardedVectorIndex":
        """Fold segments and tombstones into a clean base by rebuilding
        over the live table.  Ids are stable: the new base spans ``[0,
        n_ids)`` in id order, dead ids as sentinel-coded padding."""
        ns, dp, n_feat = self.n_shards, self.docs_per_shard, self.n_features
        flat_v = self.vectors.reshape(ns * dp, n_feat)[: self.n_docs]
        flat_l = self.live.reshape(ns * dp)[: self.n_docs]
        if self.n_appended:
            table_v = torch.zeros((self.n_ids, n_feat), device=self.device)
            table_l = torch.zeros((self.n_ids,), dtype=torch.bool,
                                  device=self.device)
            table_v[: self.n_docs] = flat_v
            table_l[: self.n_docs] = flat_l
            parts = [(s.gids, s.vectors, s.live) for s in self.segments]
            if self.seg_capacity:
                parts.append((self.seg_gids, self.seg_vectors, self.seg_live))
            # gids are unique across generations; rows merged away stay
            # unset (dead): their ids were already retired
            for sgid, svec, sliv in parts:
                sg = sgid.reshape(-1)
                used = sg >= 0
                idx = sg[used].long()
                table_v[idx] = svec.reshape(-1, n_feat)[used]
                table_l[idx] = sliv.reshape(-1)[used]
        else:
            table_v, table_l = flat_v, flat_l
        return type(self).build_sharded(
            table_v, encoder=self.encoder, index_best=self.index_best,
            live=table_l, seal_threshold=self.seal_threshold,
            mesh=self.mesh)

    def merge_segments(self, start: int = 0,
                       count: Optional[int] = None) -> "ShardedVectorIndex":
        """Merge a contiguous run of sealed segments into one, dropping its
        tombstoned rows (Lucene's background merge).

        Surviving rows keep their vectors, codes and ids, re-packed
        round-robin in id order, with a fresh posting table; the run's
        tombstones leave ``shard_tombstones``.  Assembled on the host and
        put on the device once per tensor, as the reference assembles it."""
        nseg = len(self.segments)
        if count is None:
            count = nseg - start
        if nseg == 0:
            raise ValueError("no sealed segments to merge")
        if not (0 <= start < nseg and count >= 1 and start + count <= nseg):
            raise ValueError(f"invalid merge range [{start}, {start + count}) "
                             f"of {nseg} segments")
        run = self.segments[start:start + count]
        ns, n_feat = self.n_shards, self.n_features
        C = self.codes.shape[-1]
        sentinel = _SENTINEL[self.codes.dtype]

        keep_v, keep_c, keep_g = [], [], []
        dead_per_shard = np.zeros(ns, np.int64)
        for seg in run:
            sg = seg.gids.cpu().numpy()
            sl = seg.live.cpu().numpy()
            used = sg >= 0
            dead_per_shard += (used & ~sl).sum(axis=1)
            ks, kg = np.nonzero(used & sl)
            keep_g.append(sg[ks, kg])
            keep_v.append(seg.vectors.cpu().numpy()[ks, kg])
            keep_c.append(seg.codes.cpu().numpy()[ks, kg])
        gids = np.concatenate(keep_g)
        order = np.argsort(gids, kind="stable")     # id order = append order
        gids = gids[order]
        vecs = np.concatenate(keep_v)[order]
        codes = np.concatenate(keep_c)[order]
        n_live = int(gids.size)

        old = (np.asarray(self.shard_tombstones, np.int64)
               if self.shard_tombstones else np.zeros(ns, np.int64))
        stones = old - dead_per_shard
        stones_t = tuple(int(x) for x in stones) if stones.any() else ()

        before, after = self.segments[:start], self.segments[start + count:]
        if n_live == 0:
            # every row of the run was dead: the generations just vanish
            return dataclasses.replace(self, segments=before + after,
                                       shard_tombstones=stones_t)

        w = -(-n_live // ns)
        mv = np.zeros((ns, w, n_feat), np.float32)
        mc = np.full((ns, w, C), sentinel, dtype=codes.dtype)
        mg = np.full((ns, w), -1, np.int32)
        ml = np.zeros((ns, w), bool)
        r = np.arange(n_live)
        sh, sl_ = r % ns, r // ns
        mv[sh, sl_] = vecs
        mc[sh, sl_] = codes
        mg[sh, sl_] = gids
        ml[sh, sl_] = True
        dev = self.device
        dcod = torch.from_numpy(mc).to(dev)
        with watch_region("merge.postings", sig=(w, ns)):
            pdocs, pcodes = _postings(dcod)
        merged = Segment(torch.from_numpy(mv).to(dev), dcod,
                         torch.from_numpy(mg).to(dev),
                         torch.from_numpy(ml).to(dev), pdocs, pcodes,
                         n_rows=n_live, tombstones=0)
        return dataclasses.replace(
            self, segments=before + (merged,) + after,
            shard_tombstones=stones_t)

    # ---------------------------------------------------------------- search
    def search(
        self,
        queries,
        k: int = 10,
        page: int = 320,
        trim: Optional[TrimFilter] = None,
        best: Optional[BestFilter] = None,
        engine: str = "postings",
        weighting: str = "idf",
        max_postings: "Optional[int | str]" = None,
        merge: str = "gather",
        live_groups: Optional[Tuple[int, ...]] = None,
        profile=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Two-phase search over base + generations of every shard -> (ids
        (Q, k) int32, exact cosine scores (Q, k) f32), on the index's
        device.

        Same contract as :meth:`VectorIndex.search`, with ids global, and
        bit-identical to it at ``page >= n_docs`` for either ``merge``
        transport (``"gather"`` or ``"stream"``) and any replica count.
        ``max_postings="auto"`` sizes the postings window from
        :attr:`max_df`, exact like ``None``.  ``live_groups`` names the
        replica groups that serve (the failover mask; every group by
        default): the batch's row-blocks go to those groups only.

        ``profile`` is an optional
        :class:`repro_torch.obs.profile.ProfileNode` that receives the
        reference's children: encode, phase1 (with one ``group{g}`` per
        group that served rows, ``base``, one ``gen{i}`` per sealed segment
        and ``active``, each with its candidate count: a read of the page's
        ids to the host, made in profile mode only), merge_select and
        rescore.  Under an engine's timeline sink the same boundaries
        close ``search.encode``, ``search.phase1`` (args: shards,
        generations), ``search.merge`` and ``search.rescore``, unfenced."""
        if merge not in ("gather", "stream"):
            raise ValueError(f"unknown merge transport {merge!r}")
        spec = engine_spec(engine)
        phases = PhaseRecorder(profile, self.device)
        R = self.n_replicas
        if live_groups is None:
            groups = tuple(range(R))
        else:
            groups = tuple(sorted({int(g)  # host-seam: caller's numbers
                                   for g in live_groups}))
            if not groups or groups[0] < 0 or groups[-1] >= R:
                raise ValueError(
                    f"live_groups must be a non-empty subset of [0, {R}), "
                    f"got {live_groups}")
        q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32,
                                             device=self.device))
        page = min(page, self.n_ids)
        k = min(k, page)
        page_loc = min(page, self.docs_per_shard + self.seg_capacity
                       + sum(s.width for s in self.segments))
        # round-robin over the live groups: row-block j of the batch,
        # zero-padded to U * B rows, runs on group groups[j]
        n_q, U = q.shape[0], len(groups)
        B = -(-n_q // U)
        if U * B > n_q:
            q = torch.cat([q, q.new_zeros((U * B - n_q, q.shape[1]))])
        q = normalize(q)
        qcodes = self.encoder.encode(q)
        mask = expand_mask(feature_mask(q, trim=trim, best=best),
                           qcodes.shape[-1])
        phases.close("encode", "search.encode", n_queries=n_q, groups=U)
        if max_postings == "auto":
            max_postings = max(1, self.max_df)
        L = (self.docs_per_shard if max_postings is None
             else min(max_postings, self.docs_per_shard))
        # every group holds this index's tensors: block j's query phase
        # runs on them for group groups[j]
        blocks = []
        with watch_region(
                "search.query_phase",
                sig=(tuple(q.shape), engine, weighting, page_loc, L,
                     k if merge == "stream" else 0, merge,
                     len(self.segments), self.seg_capacity > 0)):
            for j in range(U):
                rows = slice(j * B, (j + 1) * B)
                pages = self._shard_pages(q[rows], qcodes[rows], mask[rows],
                                          engine, weighting, L, page_loc)
                blocks.append(_stream_merge(pages, k) if merge == "stream"
                              else _gather_merge(pages))
        # pad rows leave before the rescore, whose (Q, k, n) shape they
        # would change
        gid, s2, cvec = (torch.cat(t)[:n_q] for t in zip(*blocks))
        q = q[:n_q]
        generations = len(self.segments) + (
            1 if self.n_appended and self.seg_capacity else 0)
        node = phases.close(
            "phase1", "search.phase1", self.n_shards, generations,
            engine=engine, kernel=engine if spec.returns_page
            else "composed", page=page, page_loc=page_loc, k=k, merge=merge)
        out = _merge_phase(gid, s2, cvec, q, k, phases, generations)
        if profile is not None:
            self._count_candidates(node, gid, n_q, groups, B)
        return out

    def _count_candidates(self, node, gid, n_q, groups, B) -> None:
        """The phase1 node's children, as the reference makes them: the
        queries each group served, then the candidate counts of the page's
        ids read to the host, split by membership into the base, each
        sealed segment and the active buffer."""
        for j, g in enumerate(groups):
            nq_j = max(0, min(n_q, (j + 1) * B) - j * B)
            if nq_j:
                node.child(f"group{g}", n_queries=nq_j)
        gh = gid.cpu().numpy()
        valid = gh[gh >= 0]
        node.attrs["candidates"] = int(valid.size)
        node.child("base", rows=self.n_docs,
                   candidates=int((valid < self.n_docs).sum()))
        appended = valid[valid >= self.n_docs]
        for gi, seg in enumerate(self.segments):
            sg = seg.gids.cpu().numpy().ravel()
            node.child(f"gen{gi}", rows=seg.n_rows, tombstones=seg.tombstones,
                       candidates=int(np.isin(appended, sg[sg >= 0]).sum()))
        if self.seg_capacity and self.n_active:
            ag = self.seg_gids.cpu().numpy().ravel()
            node.child("active", rows=self.n_active,
                       tombstones=self.active_tombstones,
                       candidates=int(np.isin(appended, ag[ag >= 0]).sum()))

    def _generations(self, s: int) -> list:
        """(vectors, codes, gids, live) of each generation's column on
        shard ``s``, (W, .) each, and the getter of its (S, W, .) int8
        table: sealed segments oldest first, then the active buffer."""
        gens = [(g.vectors[s], g.codes[s], g.gids[s], g.live[s],
                 g.quantized) for g in self.segments]
        if self.seg_capacity:
            gens.append((self.seg_vectors[s], self.seg_codes[s],
                         self.seg_gids[s], self.seg_live[s],
                         self._quant_active))
        return gens

    def _shard_pages(self, q, qcodes, mask, engine, weighting, max_postings,
                     page_loc) -> list:
        """The query phase: idf weights from the document frequencies
        summed over the shards, then each shard's page of ``page_loc``
        candidates -> [(gids (Q, P) int32, scores (Q, P), vectors
        (Q, P, n))] in shard order."""
        w = (token_weights(weighting, mask, lambda: self._df(qcodes),
                           self.n_ids)
             if engine_spec(engine).reads_tokens else None)   # no df, no idf
        return [self._shard_page(s, q, qcodes, w, engine, max_postings,
                                 page_loc) for s in range(self.n_shards)]

    def _shard_page(self, s, q, qcodes, w, engine, max_postings, page_loc):
        """Phase 1 over shard ``s``'s base + generations and the page's
        exact cosines -> (gids (Q, P) int32, scores (Q, P), vectors
        (Q, P, n))."""
        dp = self.docs_per_shard
        gens = self._generations(s)
        # a page kernel's top min(page_loc, dp) of the base holds every
        # base doc the joined selection can take
        base = phase1(engine, self.codes[s], Postings(
            self.post_docs[s], self.post_codes[s], dp),
            lambda: _quant_at(self._quant_base(), s), q, qcodes, w,
            min(page_loc, dp), live=self.live[s], max_postings=max_postings,
            max_abs_bucket=self.encoder.max_abs_bucket)
        if not engine_spec(engine).returns_page:
            s1 = base if not gens else torch.cat([base] + [
                _generation_scores(gc, gl, qcodes, w)
                for _, gc, _, gl, _ in gens], dim=1)
            cand_s, cand = stable_topk(s1, page_loc)
        elif not gens:
            cand_s, cand = base[0], base[1].long()
        else:
            # each generation's own top page, ties to the lower slot: joined
            # in generation order its stable selection is that of the scores
            # in slot order, and no doc outside a table's top page_loc can
            # reach the joined top page_loc
            parts = [base] + [phase1(
                engine, gc, None, lambda f=f: _quant_at(f(), s), q, qcodes,
                w, min(gl.shape[0], page_loc), live=gl)
                for _, gc, _, gl, f in gens]
            offs = itertools.accumulate(
                [dp] + [g[0].shape[0] for g in gens[:-1]], initial=0)
            cat_s = torch.cat([p for p, _ in parts], dim=1)
            cat_i = torch.cat([i.long() + o for (_, i), o
                               in zip(parts, offs)], dim=1)
            cand_s, pos = stable_topk(cat_s, page_loc)
            cand = torch.gather(cat_i, 1, pos)

        cvec, live_c, gid = self._gather(s, cand, gens)
        s2 = tree_dot(cvec, q[:, None, :])
        # the page kernels' -inf slots carry unspecified ids: -inf by the
        # phase-1 score, not only by the row's live flag
        s2 = s2.masked_fill(~live_c | torch.isneginf(cand_s), _NEG_INF)
        return gid, s2, cvec

    def _gather(self, s, cand, gens):
        """Rows of shard ``s``'s joined positions ``cand`` (Q, P) ->
        (vectors (Q, P, n), live (Q, P), global ids (Q, P) int32): one
        gather from the base and one from the generations, joined into one
        table for this call (a few MB per 4,096 rows, against a (Q, P, n)
        gather per generation)."""
        dp = self.docs_per_shard
        base = cand.clamp(max=dp - 1)
        cvec, live_c = self.vectors[s][base], self.live[s][base]
        gid = (base + self.offsets[s]).to(torch.int32)
        if not gens:
            return cvec, live_c, gid
        gv, gg, gl = (torch.cat(t) for t in
                      zip(*((gen[0], gen[2], gen[3]) for gen in gens)))
        inside = cand >= dp
        loc = (cand - dp).clamp(0, gv.shape[0] - 1)
        cvec = torch.where(inside[..., None], gv[loc], cvec)
        live_c = torch.where(inside, gl[loc], live_c)
        gid = torch.where(inside, gg[loc], gid)
        return cvec, live_c, gid


def _shards_df(post_docs, post_codes, qcodes) -> torch.Tensor:
    """(Q, C) int32 document frequencies summed over the S shards of
    (S, C, W) posting tables: one lookup over the S * C sorted rows."""
    ns, n_cols, w = post_codes.shape
    df = df_lookup(Postings(post_docs.reshape(ns * n_cols, w),
                            post_codes.reshape(ns * n_cols, w), w),
                   qcodes.repeat(1, ns))
    return df.view(-1, ns, n_cols).sum(dim=1, dtype=torch.int32)


def _generation_scores(codes, live, qcodes, w) -> torch.Tensor:
    """(Q, W) code-match scores of one generation, -inf where not live:
    the ``code_match`` kernel on the card, its plain version on the CPU;
    both sum a row in an order that does not depend on W."""
    from repro_torch.kernels.code_match import ops as cm_ops

    return cm_ops.code_match(codes, qcodes, w).masked_fill(~live[None, :],
                                                           _NEG_INF)


def _gather_merge(pages):
    """The shard pages joined shard-major: (gids, scores, vectors) of
    width S * P."""
    if len(pages) == 1:
        return pages[0]
    return tuple(torch.cat(t, dim=1) for t in zip(*pages))


def _stream_merge(pages, k):
    """The shard pages folded in shard order into a running stable top-
    ``k``: each step selects from ``[acc | page]``, the accumulator first,
    so ties keep the lower shard and the fold returns the gather's top-
    ``k`` bit for bit, holding at most ``k + P`` candidates a query."""
    acc = None
    for page in pages:
        cat = page if acc is None else tuple(
            torch.cat(t, dim=1) for t in zip(acc, page))
        _, pos = stable_topk(cat[1], min(k, cat[1].shape[1]))
        acc = _take(pos, *cat)
    return acc


def _take(pos, gid, s2, cvec):
    """Columns ``pos`` (Q, K) of the page's gids, scores and vectors."""
    n = cvec.shape[-1]
    return (torch.gather(gid, 1, pos), torch.gather(s2, 1, pos),
            torch.gather(cvec, 1, pos[..., None].expand(-1, -1, n)))


def _merge_phase(gid, s2, cvec, q, k, phases, generations):
    """Stable top-``k`` over the page's exact cosines, then the reported
    scores from the (Q, k, n) einsum of ``exact_scores``; slots whose
    score is -inf report (id=-1, score=-inf).  The two steps close
    ``phases``' ``merge_select`` / ``search.merge`` and ``rescore`` /
    ``search.rescore``."""
    with watch_region("search.merge_select",
                      sig=(tuple(gid.shape), k, generations)):
        top_s, pos = stable_topk(s2, k)
        top_ids, _, hits = _take(pos, gid, s2, cvec)
        top_ids = top_ids.masked_fill(torch.isneginf(top_s), -1)
    phases.close("merge_select", "search.merge", k=k,
                 generations=generations)
    check_fp32_matmul(hits)
    with watch_region("search.rescore", sig=(tuple(q.shape), k)):
        scores = torch.einsum("qkn,qn->qk", hits, q)
        scores = scores.masked_fill(top_ids < 0, _NEG_INF)
    short = k - top_ids.shape[1]
    if short > 0:          # fewer slots than k once merges reclaimed rows
        top_ids = torch.nn.functional.pad(top_ids, (0, short), value=-1)
        scores = torch.nn.functional.pad(scores, (0, short),
                                         value=_NEG_INF)
    phases.close("rescore", "search.rescore", k=k)
    return top_ids, scores


def _quant_at(table: Quant, s: int) -> QuantizedTable:
    """Shard ``s``'s slice of an (S, W, .) int8 table."""
    return QuantizedTable(*(t[s] for t in table))


def _max_df(post_codes: torch.Tensor, sentinel: int) -> int:
    """Longest run of one non-sentinel code in any row of (C, d) sorted
    posting codes, ``_DF_COLUMNS`` rows a step."""
    best = 0
    for j in range(0, post_codes.shape[0], _DF_COLUMNS):
        x = post_codes[j:j + _DF_COLUMNS]
        start = torch.ones(x.shape, dtype=torch.bool, device=x.device)
        start[:, 1:] = x[:, 1:] != x[:, :-1]
        pos = start.reshape(-1).nonzero().squeeze(1)
        length = torch.diff(pos, append=pos.new_full((1,), x.numel()))
        length = length[x.reshape(-1)[pos] != sentinel]
        if length.numel():
            best = max(best, int(length.max()))
    return best
