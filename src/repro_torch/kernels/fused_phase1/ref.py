"""Plain PyTorch versions of the fused phase-1 kernels.

:func:`fused_phase1_ref` and :func:`fused_phase1_quant_ref` are the
composed paths the kernels replace: materialize the full (Q, d) phase-1
score matrix (code matches, or quantized dots), mask dead rows, then one
global stable top-``page``.  :func:`fused_phase1_stream` and
:func:`fused_phase1_quant_stream` compute the same functions one doc tile
at a time, folding each tile into a running stable top-``page``, so no
(Q, d) matrix exists; they are what the public wrappers run for tensors
on the CPU.

:func:`match_scores` is the one fp32 scorer of the whole family: select
the matching weights, then sum the C code columns with a fixed pairwise
tree, zero-padded to a power of two (``x[..., :h] + x[..., h:]`` until one
column is left).  The order of the adds is a pure function of C, so the
bits of a (query, doc) score cannot depend on how the doc or query axis is
tiled, and they equal the JAX reference's ``match_scores`` exactly.  The
CUDA kernel adds the same leaves in the same order (see its source note).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import quantized_scores
from repro_torch.core.rerank import stable_topk

__all__ = ["match_scores", "fused_phase1_ref", "fused_phase1_stream",
           "fused_phase1_quant_ref", "fused_phase1_quant_stream"]


def match_scores(doc_codes: torch.Tensor,    # (d, C) int
                 qcodes: torch.Tensor,       # (Q, C) int
                 col_weights: torch.Tensor,  # (Q, C) f32
                 ) -> torch.Tensor:
    """Code-match scores (Q, d): select the matching weights, then sum the
    C axis with the fixed pairwise tree (see module doc)."""
    x = torch.where(qcodes[:, None, :] == doc_codes[None, :, :],
                    col_weights[:, None, :], 0.0)          # (Q, d, C)
    n = x.shape[-1]
    p2 = 1 << max(n - 1, 0).bit_length()                   # next power of two
    if p2 != n:
        x = F.pad(x, (0, p2 - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _mask_topk(scores: torch.Tensor, live: Optional[torch.Tensor],
               page: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if live is not None:
        scores = scores.masked_fill(~live[None, :], float("-inf"))
    top_s, top_i = stable_topk(scores, page)
    return top_s, top_i.to(torch.int32)


def fused_phase1_ref(
    doc_codes: torch.Tensor,    # (d, C) int
    qcodes: torch.Tensor,       # (Q, C) int
    col_weights: torch.Tensor,  # (Q, C) f32
    page: int,
    live: Optional[torch.Tensor] = None,   # (d,) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composed fp32 reference: match scores -> mask -> stable top-``page``."""
    return _mask_topk(match_scores(doc_codes, qcodes, col_weights), live,
                      page)


def fused_phase1_quant_ref(
    codes8: torch.Tensor,     # (d, n) int8 quantized rows
    scale: torch.Tensor,      # (d,) f32
    zero: torch.Tensor,       # (d,) f32
    queries: torch.Tensor,    # (Q, n) f32
    page: int,
    live: Optional[torch.Tensor] = None,   # (d,) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composed int8 reference: quantized scores -> mask -> stable
    top-``page``."""
    qsum = queries.sum(dim=-1, keepdim=True)
    return _mask_topk(quantized_scores(codes8, scale, zero, queries, qsum),
                      live, page)


def _stream(score_tile: Callable[[int, int], torch.Tensor], d: int, Q: int,
            page: int, live: Optional[torch.Tensor], block: int,
            dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold ``score_tile(lo, hi)`` -> (Q, hi - lo) scores over the doc
    axis, ``block`` docs a step, into a running stable top-``page``.  The
    accumulator always holds lower doc ids than the tile after it, so the
    fold equals one global stable top-k."""
    acc_s = torch.full((Q, 0), float("-inf"), device=dev)
    acc_i = torch.zeros((Q, 0), dtype=torch.int64, device=dev)
    for base in range(0, d, block):
        s = score_tile(base, min(base + block, d))
        if live is not None:
            s = s.masked_fill(~live[None, base:base + block], float("-inf"))
        ids = torch.arange(base, base + s.shape[1], device=dev)
        cat_s = torch.cat([acc_s, s], dim=1)
        cat_i = torch.cat([acc_i, ids.expand(Q, -1)], dim=1)
        acc_s, pos = stable_topk(cat_s, page)
        acc_i = torch.gather(cat_i, 1, pos)
    return acc_s, acc_i.to(torch.int32)


def fused_phase1_stream(
    doc_codes: torch.Tensor,    # (d, C) int
    qcodes: torch.Tensor,       # (Q, C) int
    col_weights: torch.Tensor,  # (Q, C) f32
    page: int,
    live: Optional[torch.Tensor] = None,   # (d,) bool
    block: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-by-tile fold of :func:`fused_phase1_ref`: scores bit-equal to
    the composed reference, ids equal wherever the score is finite."""
    return _stream(
        lambda lo, hi: match_scores(doc_codes[lo:hi], qcodes, col_weights),
        doc_codes.shape[0], qcodes.shape[0], page, live, block,
        doc_codes.device)


def fused_phase1_quant_stream(
    codes8: torch.Tensor,     # (d, n) int8 quantized rows
    scale: torch.Tensor,      # (d,) f32
    zero: torch.Tensor,       # (d,) f32
    queries: torch.Tensor,    # (Q, n) f32
    page: int,
    live: Optional[torch.Tensor] = None,   # (d,) bool
    block: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-by-tile fold of :func:`fused_phase1_quant_ref`: the same
    scores per cell up to the matrix product's reduction order."""
    qsum = queries.sum(dim=-1, keepdim=True)
    return _stream(
        lambda lo, hi: quantized_scores(codes8[lo:hi], scale[lo:hi],
                                        zero[lo:hi], queries, qsum),
        codes8.shape[0], queries.shape[0], page, live, block, codes8.device)
