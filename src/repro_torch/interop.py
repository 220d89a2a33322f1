"""Carry models and indexes built by the JAX package across to this one.

Each function takes the numpy leaves of a JAX object and builds the
port's object on ``device`` with the very same bits, so both packages can
run one model or search one index:

* ``index_from_numpy``: a ``VectorIndex`` (vectors, codes, postings, plus
  the port's encoder of the same scheme and ``index_best``);
* ``lsa_from_numpy``: an ``LsaPipeline`` (idf, V, singular values, doc
  vectors), so ``embed`` and ``fold_in`` run on the same model;
* ``mlt_from_numpy``: an ``MLTIndex`` (its term postings and the corpus).

This module imports no JAX: the caller does the ``np.asarray``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.encoding import Encoder
from repro_torch.core.mlt import MLTIndex, TermPostings
from repro_torch.core.postings import Postings
from repro_torch.core.search import VectorIndex
from repro_torch.lsa import LsaModel, LsaPipeline, TfIdf

__all__ = ["index_from_numpy", "lsa_from_numpy", "mlt_from_numpy"]


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
