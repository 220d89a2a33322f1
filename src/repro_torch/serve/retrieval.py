"""Paper-integrated candidate retrieval for the recsys serving path.

``retrieval_cand`` (1 query x 1,000,000 candidates) IS the paper's workload:
instead of a brute-force (1M x D) dot per request, candidates are indexed
once with the paper's vector-to-code encoding, and each request runs the
two-phase search -- phase-1 code match over int8 codes (4x fewer bytes than
f32 embeddings, further reduced by query trim), phase-2 exact dot over the
``page`` survivors.  The brute force is kept as the baseline (same
avg.diff/P@k metrics as the paper).

The JAX package's ``serve/retrieval.py`` in PyTorch, in its order of
operations.  The phase-1 weights are 0 or 1, so every phase-1 score is a
whole count, exact in float32 in any summation order, and the page is a
stable top-``page`` (ties to the lower index, as ``jax.lax.top_k``): the
page's ids are the reference's exactly.  ``brute_force_retrieval`` ranks
by one (Q, N) product, as the reference does, and reports the
``exact_scores`` of its ids, the product ``retrieval_step`` reports: at
``page`` = N the two answers hold the same ids and scores, but where two
candidates' scores lie within the two products' rounding of each other.
Both phases' products run in plain float32: on the card, TF32 off.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.codes import score_codes
from repro_torch.core.encoding import Encoder, RoundingEncoder
from repro_torch.core.filtering import TrimFilter, expand_mask, feature_mask
from repro_torch.core.rerank import (check_fp32_matmul, exact_scores,
                                     normalize, rerank_topk, stable_topk)

__all__ = ["encode_candidates", "retrieval_page", "retrieval_step",
           "brute_force_retrieval"]


def encode_candidates(cand_vecs: torch.Tensor,
                      encoder: Encoder = RoundingEncoder(2)):
    """Index build: (N, D) candidate embeddings -> unit vectors + int codes."""
    v = normalize(cand_vecs.float())
    return v, encoder.encode(v)


def retrieval_page(
    user_vec: torch.Tensor,     # (Q, D) user-tower output
    cand_codes: torch.Tensor,   # (N, C) int codes (encode_candidates)
    encoder: Encoder = RoundingEncoder(2),
    page: int = 512,
    trim_threshold: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 -> (unit queries (Q, D), candidate page (Q, page) int64)."""
    q = normalize(user_vec.float())
    qcodes = encoder.encode(q)
    mask = expand_mask(
        feature_mask(q, trim=TrimFilter(trim_threshold)), qcodes.shape[-1]
    )
    w = torch.where(mask, 1.0, 0.0)
    scores1 = score_codes(cand_codes, qcodes, w)
    _, cand = stable_topk(scores1, page)
    return q, cand


def retrieval_step(
    user_vec: torch.Tensor,     # (Q, D) user-tower output
    cand_vecs: torch.Tensor,    # (N, D) unit candidate vectors
    cand_codes: torch.Tensor,   # (N, C) int codes (encode_candidates)
    encoder: Encoder = RoundingEncoder(2),
    page: int = 512,
    k: int = 100,
    trim_threshold: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-phase retrieval -> (ids (Q, k) int32, scores (Q, k))."""
    q, cand = retrieval_page(user_vec, cand_codes, encoder, page,
                             trim_threshold)
    return rerank_topk(cand_vecs, cand, q, k)


def brute_force_retrieval(user_vec: torch.Tensor, cand_vecs: torch.Tensor,
                          k: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-``k`` over every candidate -> (ids (Q, k) int32, scores)."""
    check_fp32_matmul(cand_vecs)
    q = normalize(user_vec.float())
    _, top = stable_topk(q @ cand_vecs.T, k)
    return top.to(torch.int32), exact_scores(cand_vecs, top, q)
