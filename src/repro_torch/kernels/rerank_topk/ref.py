"""Plain PyTorch versions of the rerank kernel.

:func:`rerank_scores_ref` is the reference's oracle on gathered
candidates, ``scores[q, p] = sum_n cand[q, p, n] * query[q, n]`` as one
einsum; :func:`candidate_scores_ref` is the function the CUDA kernel
computes, the gather of the candidate rows by id and then the same
einsum.  Both run in plain float32 (TF32 off on the card).
:func:`lane_order_scores` is the same function summed in the CUDA
kernels' order (lane partials of ``fmaf`` steps, then the warp's shuffle
tree), bit for bit, with :func:`fma32` as the card's ``fmaf``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.rerank import check_fp32_matmul

__all__ = ["rerank_scores_ref", "candidate_scores_ref", "fma32",
           "lane_order_scores"]


def rerank_scores_ref(cand_vecs: torch.Tensor,
                      queries: torch.Tensor) -> torch.Tensor:
    """(Q, P, n), (Q, n) -> (Q, P) exact cosine (inputs unit-normalised)."""
    check_fp32_matmul(cand_vecs)
    return torch.einsum("qpn,qn->qp", cand_vecs, queries)


def candidate_scores_ref(vectors: torch.Tensor, cand_ids: torch.Tensor,
                         queries: torch.Tensor) -> torch.Tensor:
    """(d, n) table, (Q, P) ids, (Q, n) queries -> (Q, P) scores."""
    return rerank_scores_ref(vectors[cand_ids.long()], queries)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, c)`` on float32 tensors, rounded once as the card
    rounds it: the product is exact in float64, the sum is rounded to odd
    there (TwoSum's error moves an inexact result with an even last bit one
    ulp toward the exact sum), and float64 -> float32 then rounds
    correctly, 53 bits being at least 24 + 2."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, toward),
                       s).float()


def lane_order_scores(vectors: torch.Tensor, cand_ids: torch.Tensor,
                      queries: torch.Tensor, vec: bool = True
                      ) -> torch.Tensor:
    """(d, n) table, (Q, P) ids (clamped to [0, d)), (Q, n) queries ->
    (Q, P) scores summed as the CUDA kernels sum them: lane l of a warp
    takes float4s l, l + 32, ... of the row (``vec``, n % 4 == 0; else
    floats), one ``fmaf`` a float in order, and the 32 lane partials meet
    in a shuffle tree (xor 16, 8, 4, 2, 1)."""
    w = 4 if vec else 1
    n = vectors.shape[1]
    if n % w:
        raise ValueError(f"the vector order needs n % 4 == 0, got n={n}")
    rows = vectors[cand_ids.long().clamp(0, vectors.shape[0] - 1)]
    steps = -(-(n // w) // 32)
    pad = steps * 32 * w - n
    a = F.pad(rows, (0, pad)).unflatten(-1, (steps, 32, w))
    b = F.pad(queries, (0, pad)).unflatten(-1, (steps, 32, w))[:, None]
    lanes = torch.arange(32, device=vectors.device)
    acc = torch.zeros(rows.shape[:2] + (32,), device=vectors.device)
    for j in range(steps):
        live = j * 32 + lanes < n // w
        for c in range(w):
            acc = torch.where(live, fma32(a[..., j, :, c], b[..., j, :, c],
                                          acc), acc)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    return acc[..., 0]
