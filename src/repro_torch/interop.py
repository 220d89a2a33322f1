"""Carry an index built by the JAX package across to this package.

The JAX ``VectorIndex`` flattens to the leaves (vectors, codes, postings)
plus the encoder and ``index_best``.  ``index_from_numpy`` takes those
leaves as numpy arrays, and the port's encoder of the same scheme, and
builds the port's :class:`VectorIndex` on ``device`` with the very same
bits, so both packages can search one index.  This module imports no JAX:
the caller does the ``np.asarray``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.encoding import Encoder
from repro_torch.core.postings import Postings
from repro_torch.core.search import VectorIndex

__all__ = ["index_from_numpy"]


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
    def put(a):
        return torch.tensor(np.ascontiguousarray(a), device=device)

    codes_t = put(codes)
    if codes_t.dtype != encoder.code_dtype:
        raise TypeError(f"codes are {codes_t.dtype}, encoder "
                        f"{encoder} makes {encoder.code_dtype}")
    postings = Postings(post_docs=put(post_docs).to(torch.int32),
                        post_codes=put(post_codes),
                        n_docs=int(codes.shape[0]))
    return VectorIndex(put(vectors).to(torch.float32), codes_t, postings,
                       encoder, index_best)
