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
CUDA kernels add the same leaves in the same order, evaluated another way
(``kernels/csrc/match_tree.cuh``): :func:`match_scores_words` is that
evaluation order in torch, which the tests hold bit-equal to the
reference's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import quantized_scores
from repro_torch.core.rerank import stable_topk

__all__ = ["match_scores", "match_scores_words", "fused_phase1_ref",
           "fused_phase1_stream", "fused_phase1_quant_ref",
           "fused_phase1_quant_stream"]


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


_BLOCK_LOG = 4      # match_tree.cuh's kBlockLog


def _bitrev(x: int, bits: int) -> int:
    return int(f"{x:0{bits}b}"[::-1], 2) if bits else 0


def _carry_fold(values):
    """Adjacent-pair tree over ``values`` (a power-of-two count) in walk
    order, by a carry stack: step t merges trailing_ones(t) times."""
    stack = []
    for t, v in enumerate(values):
        while t & 1:
            v = stack.pop() + v
            t >>= 1
        stack.append(v)
    return stack[-1]


def match_scores_words(doc_codes: torch.Tensor,    # (d, C) int
                       qcodes: torch.Tensor,       # (Q, C) int
                       col_weights: torch.Tensor,  # (Q, C) f32
                       ) -> torch.Tensor:
    """:func:`match_scores` (Q, d) in the CUDA kernels' evaluation order,
    for tests: the query rows padded with zero weights to whole 4-column
    groups; a 32-bit word of g = 4 / itemsize codes giving one leaf to each
    of g interleaved subtrees; the words walked in bit-reversed order,
    blocks of 2^min(L, 4) steps at a time, words past C as +0.0; the
    subtrees combined as (a0 + a2) + (a1 + a3), a0 + a1 or a0."""
    C = doc_codes.shape[1]
    g = 4 // doc_codes.element_size()
    x = torch.where(qcodes[:, None, :] == doc_codes[None, :, :],
                    col_weights[:, None, :], 0.0)
    x = F.pad(x, (0, -C % 4))
    pc = 1 << max(C - 1, 0).bit_length()
    if pc < g:                      # one word holds the whole tree
        return x[..., 0] if pc == 1 else x[..., 0] + x[..., 1]
    L = (pc // g).bit_length() - 1
    u = min(L, _BLOCK_LOG)
    lnb = L - u
    cw = -(-C // g)
    zero = torch.zeros(x.shape[:2] + (g,), dtype=x.dtype)

    def leaves(m):
        return x[..., m * g:(m + 1) * g] if m < cw else zero

    def block(blk):
        base = _bitrev(blk, lnb)
        return _carry_fold([leaves(base + (_bitrev(j, u) << lnb))
                            for j in range(1 << u)])

    a = _carry_fold([block(b) for b in range(1 << lnb)])
    if g == 4:
        return (a[..., 0] + a[..., 2]) + (a[..., 1] + a[..., 3])
    return a[..., 0] + a[..., 1] if g == 2 else a[..., 0]


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
