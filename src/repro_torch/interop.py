"""Carry models and indexes built by the JAX package across to this one.

Each function takes the numpy leaves of a JAX object and builds the
port's object on ``device`` with the very same bits, so both packages can
run one model or search one index:

* ``index_from_numpy``: a ``VectorIndex`` (vectors, codes, postings, plus
  the port's encoder of the same scheme and ``index_best``);
* ``lsa_from_numpy``: an ``LsaPipeline`` (idf, V, singular values, doc
  vectors), so ``embed`` and ``fold_in`` run on the same model;
* ``mlt_from_numpy``: an ``MLTIndex`` (its term postings and the corpus);
* ``sharded_from_numpy``: a ``ShardedVectorIndex`` of any shard count
  (its base, active buffer and sealed segments, and the host counters);
* ``lm_params_from_numpy`` / ``lm_params_to_numpy``: an LM's parameter
  tree (leaves stacked over ``n_super``) to the port's ``LM`` module and
  back, and the same for an ``AdamWState`` or ``AdafactorState`` (the
  port keeps optimizer state in the reference's tree already).  bf16
  leaves come back widened to f32 (numpy has no bf16).

This module imports no JAX: the caller does the ``np.asarray``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.encoding import Encoder
from repro_torch.core.mlt import MLTIndex, TermPostings
from repro_torch.core.postings import Postings
from repro_torch.core.search import VectorIndex
from repro_torch.dist.shard_index import (DEFAULT_SEAL_THRESHOLD, Segment,
                                          ShardedVectorIndex, resolve_mesh)
from repro_torch.launch.mesh import make_shard_mesh
from repro_torch.lsa import LsaModel, LsaPipeline, TfIdf
from repro_torch.models.transformer.model import LM, LMConfig
from repro_torch.train.optimizer import AdafactorState, AdamWState
from repro_torch.train.tree import tree_map

__all__ = ["index_from_numpy", "lsa_from_numpy", "mlt_from_numpy",
           "sharded_from_numpy", "lm_params_from_numpy", "lm_params_to_numpy"]


def _put(a, device, dtype=None):
    return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def index_from_numpy(
    vectors: np.ndarray,       # (d, n) f32, unit rows
    codes: np.ndarray,         # (d, C) int
    post_docs: np.ndarray,     # (C, d) int32
    post_codes: np.ndarray,    # (C, d) int, same dtype as codes
    encoder: Encoder,
    index_best: Optional[int] = None,
    device="cuda",
) -> VectorIndex:
    """Port :class:`VectorIndex` on ``device`` from the numpy leaves of a
    JAX ``VectorIndex`` (see module doc)."""
    codes_t = _put(codes, device)
    if codes_t.dtype != encoder.code_dtype:
        raise TypeError(f"codes are {codes_t.dtype}, encoder "
                        f"{encoder} makes {encoder.code_dtype}")
    postings = Postings(post_docs=_put(post_docs, device, torch.int32),
                        post_codes=_put(post_codes, device),
                        n_docs=int(codes.shape[0]))
    return VectorIndex(_put(vectors, device, torch.float32), codes_t, postings,
                       encoder, index_best)


def lsa_from_numpy(
    idf: np.ndarray,        # (vocab,) f32
    v: np.ndarray,          # (vocab, k) f32
    s: np.ndarray,          # (k,) f32
    doc_vecs: np.ndarray,   # (d, k) f32
    device="cuda",
) -> LsaPipeline:
    """Port :class:`LsaPipeline` on ``device`` from the numpy leaves of a
    JAX ``LsaPipeline`` (``tfidf.idf``, ``lsa.v``, ``lsa.s``,
    ``lsa.doc_vecs``)."""
    f32 = torch.float32
    return LsaPipeline(
        tfidf=TfIdf(idf=_put(idf, device, f32), vocab_size=int(idf.shape[0])),
        lsa=LsaModel(v=_put(v, device, f32), s=_put(s, device, f32),
                     doc_vecs=_put(doc_vecs, device, f32)))


def mlt_from_numpy(
    sorted_terms: np.ndarray,   # (nnz,) int32
    sorted_docs: np.ndarray,    # (nnz,) int32
    sorted_tf: np.ndarray,      # (nnz,) f32
    idf: np.ndarray,            # (vocab,) f32
    doc_terms: np.ndarray,      # (d, T) int32
    doc_tf: np.ndarray,         # (d, T) f32
    device="cuda",
) -> MLTIndex:
    """Port :class:`MLTIndex` on ``device`` from the numpy leaves of a JAX
    ``MLTIndex`` (its ``postings`` fields and the corpus)."""
    i32, f32 = torch.int32, torch.float32
    postings = TermPostings(_put(sorted_terms, device, i32),
                            _put(sorted_docs, device, i32),
                            _put(sorted_tf, device, f32),
                            _put(idf, device, f32), int(doc_terms.shape[0]))
    return MLTIndex(postings, _put(doc_terms, device, i32),
                    _put(doc_tf, device, f32))


def sharded_from_numpy(
    vectors: np.ndarray,       # (S, dp, n) f32
    codes: np.ndarray,         # (S, dp, C) int
    post_docs: np.ndarray,     # (S, C, dp) int32
    post_codes: np.ndarray,    # (S, C, dp) int
    offsets: np.ndarray,       # (S,) int32
    live: np.ndarray,          # (S, dp) bool
    encoder: Encoder,
    n_docs: int,
    index_best: Optional[int] = None,
    *,
    seg_vectors: Optional[np.ndarray] = None,   # (S, G, n); None: empty
    seg_codes: Optional[np.ndarray] = None,     # (S, G, C)
    seg_gids: Optional[np.ndarray] = None,      # (S, G) int32
    seg_live: Optional[np.ndarray] = None,      # (S, G) bool
    segments: Sequence = (),   # (vectors, codes, gids, live, post_docs,
                               #  post_codes, n_rows, tombstones) each
    n_appended: int = 0,
    shard_tombstones: Sequence[int] = (),
    seal_threshold: Optional[int] = DEFAULT_SEAL_THRESHOLD,
    seg_base: int = 0,
    active_tombstones: int = 0,
    mesh=None,
    device=None,
) -> ShardedVectorIndex:
    """Port a :class:`ShardedVectorIndex` from the numpy leaves of a JAX
    ``ShardedVectorIndex`` and its host counters, on ``mesh`` (or, on
    ``device``, the one-group mesh of the leaves' S shards); its segments
    come along when given.  Raises ``ValueError`` when the leaves' shard
    count is not the mesh's."""
    ns = vectors.shape[0]
    if mesh is None:
        mesh = make_shard_mesh(ns, device="cuda" if device is None
                               else device)
    else:
        mesh = resolve_mesh(mesh, device)
    if mesh.n_shards != ns or np.shape(offsets) != (ns,):
        raise ValueError(f"leaves of {ns} shards (offsets "
                         f"{np.shape(offsets)}) on a mesh of "
                         f"{mesh.n_shards} shards")
    device = mesh.device
    codes_t = _put(codes, device)
    if codes_t.dtype != encoder.code_dtype:
        raise TypeError(f"codes are {codes_t.dtype}, encoder "
                        f"{encoder} makes {encoder.code_dtype}")
    f32, i32 = torch.float32, torch.int32
    if seg_vectors is None:
        active = ShardedVectorIndex._empty_active(
            ns, vectors.shape[2], codes.shape[2], codes_t.dtype, device)
    else:
        active = {"seg_vectors": _put(seg_vectors, device, f32),
                  "seg_codes": _put(seg_codes, device, codes_t.dtype),
                  "seg_gids": _put(seg_gids, device, i32),
                  "seg_live": _put(seg_live, device, torch.bool)}
    segs = tuple(
        Segment(_put(sv, device, f32), _put(sc, device, codes_t.dtype),
                _put(sg, device, i32), _put(sl, device, torch.bool),
                _put(spd, device, i32), _put(spc, device, codes_t.dtype),
                int(n_rows), int(tombs))
        for sv, sc, sg, sl, spd, spc, n_rows, tombs in segments)
    return ShardedVectorIndex(
        vectors=_put(vectors, device, f32), codes=codes_t,
        post_docs=_put(post_docs, device, i32),
        post_codes=_put(post_codes, device, codes_t.dtype),
        offsets=_put(offsets, device, i32),
        live=_put(live, device, torch.bool), segments=segs, encoder=encoder,
        n_docs=int(n_docs), index_best=index_best,
        n_appended=int(n_appended),
        shard_tombstones=tuple(int(x) for x in shard_tombstones),
        seal_threshold=seal_threshold, seg_base=int(seg_base),
        active_tombstones=int(active_tombstones), mesh=mesh, **active)


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.tensor(a, device=device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def lm_params_from_numpy(tree, cfg: LMConfig, device="cuda"):
    """The reference's LM parameter tree (numpy leaves, stacked over
    ``n_super``) -> an :class:`LM` on ``device`` holding the same bits; an
    ``AdamWState`` / ``AdafactorState`` of numpy trees -> the same state
    of tensors on ``device``."""
    for state in (AdamWState, AdafactorState):
        if getattr(tree, "_fields", None) == state._fields:
            return state(*tree_map(lambda a: _leaf_to_torch(a, device),
                                   tuple(tree)))
    model = LM(cfg, device=device)
    return model.load_tree(tree_map(lambda a: _leaf_to_torch(a, device), tree))


def lm_params_to_numpy(params):
    """An :class:`LM` -> the reference's parameter tree of numpy arrays
    (stacked over ``n_super``); an optimizer state -> its numpy trees."""
    tree = params.tree() if isinstance(params, LM) else params
    return tree_map(_leaf_to_numpy, tree)
