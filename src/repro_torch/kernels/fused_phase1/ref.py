"""Plain PyTorch versions of the fused phase-1 kernel.

:func:`fused_phase1_ref` is the composed path the kernel replaces:
materialize the full (Q, d) phase-1 score matrix, mask dead rows, then one
global stable top-``page``.  :func:`fused_phase1_stream` computes the same
function one doc tile at a time, folding each tile into a running stable
top-``page``, so no (Q, d) matrix exists; it is what the public wrapper
runs for tensors on the CPU.

:func:`match_scores` is the one fp32 scorer of the whole family: select
the matching weights, then sum the C code columns with a fixed pairwise
tree, zero-padded to a power of two (``x[..., :h] + x[..., h:]`` until one
column is left).  The order of the adds is a pure function of C, so the
bits of a (query, doc) score cannot depend on how the doc or query axis is
tiled, and they equal the JAX reference's ``match_scores`` exactly.  The
CUDA kernel adds the same leaves in the same order (see its source note).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.rerank import stable_topk

__all__ = ["match_scores", "fused_phase1_ref", "fused_phase1_stream"]


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


def fused_phase1_stream(
    doc_codes: torch.Tensor,    # (d, C) int
    qcodes: torch.Tensor,       # (Q, C) int
    col_weights: torch.Tensor,  # (Q, C) f32
    page: int,
    live: Optional[torch.Tensor] = None,   # (d,) bool
    block: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-by-tile fold of :func:`fused_phase1_ref`: score ``block`` docs,
    fold them into a running stable top-``page``.  The accumulator always
    holds lower doc ids than the tile after it, so the fold equals one
    global stable top-k: scores bit-equal to the composed reference, ids
    equal wherever the score is finite."""
    d = doc_codes.shape[0]
    Q = qcodes.shape[0]
    dev = doc_codes.device
    acc_s = torch.full((Q, 0), float("-inf"), device=dev)
    acc_i = torch.zeros((Q, 0), dtype=torch.int64, device=dev)
    for base in range(0, d, block):
        s = match_scores(doc_codes[base:base + block], qcodes, col_weights)
        if live is not None:
            s = s.masked_fill(~live[None, base:base + block], float("-inf"))
        ids = torch.arange(base, base + s.shape[1], device=dev)
        cat_s = torch.cat([acc_s, s], dim=1)
        cat_i = torch.cat([acc_i, ids.expand(Q, -1)], dim=1)
        acc_s, pos = stable_topk(cat_s, page)
        acc_i = torch.gather(cat_i, 1, pos)
    return acc_s, acc_i.to(torch.int32)
