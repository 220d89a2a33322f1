"""Public wrappers of the fused phase-1 kernels.

``fused_phase1`` scores every document by weighted code matches and keeps
the top-``page`` in one pass, with no (Q, d) score matrix;
``fused_phase1_quant`` does the same over the int8 per-row table
(:mod:`repro_torch.core.quantize`).  A CUDA tensor goes to the hand-written
kernel (:mod:`.kernel`) or raises; a CPU tensor goes to the plain version
(:func:`.ref.fused_phase1_stream`, :func:`.ref.fused_phase1_quant_stream`,
folding the doc axis in tiles of 512).  ``fused_phase1`` is bit-equal to
the composed reference in scores, and equal in ids wherever the score is
finite; ``fused_phase1_quant`` agrees with its composed reference to float
tolerance: on the card its queries go into the int8 tensor cores as three
int8 pieces, and its scores equal :func:`.ref.quant_split_scores` bit for
bit.

Contract for -inf slots: when fewer than ``page`` docs are live, the
trailing -inf slots carry an unspecified but in-range doc id.

``launches`` and ``quant_launches`` count the CUDA kernels each wrapper
launched: each call on the card launches two, ``score_fold_kernel`` and
``merge_splits_kernel`` (:data:`.kernel.KERNELS_PER_CALL`).  Calls made
straight to :mod:`.kernel`, as a comparison with the plain version does,
are not counted.  A run resets them to 0 to show that a path went through
the kernels.  The counts are guarded by a lock: batchers on several
threads launch at once.  Each call, on either path, first files its work
as a cost row (:func:`repro_torch.obs.cost.kernel_call`).
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from repro_torch.obs import cost

from . import kernel, ref

__all__ = ["fused_phase1", "fused_phase1_quant", "launches",
           "quant_launches"]

launches = 0
quant_launches = 0
_lock = threading.Lock()

_CPU_BLOCK_D = 512


def fused_phase1(
    doc_codes: torch.Tensor,    # (d, C) int
    qcodes: torch.Tensor,       # (Q, C) int
    col_weights: torch.Tensor,  # (Q, C) f32
    page: int,
    live: Optional[torch.Tensor] = None,   # (d,) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused fp32 phase-1 -> (scores (Q, page) f32, ids (Q, page) int32),
    with ``page`` clamped to the doc count."""
    global launches
    d, C = doc_codes.shape
    page = int(min(page, d))
    with cost.kernel_call("fused_phase1", cost.fused_phase1_work(
            d, qcodes.shape[0], C, page, doc_codes.element_size(),
            live is not None)):
        if doc_codes.is_cuda:
            out = kernel.fused_phase1_cuda(doc_codes, qcodes, col_weights,
                                           page, live)
            with _lock:
                launches += kernel.KERNELS_PER_CALL
            return out
        s, i = ref.fused_phase1_stream(doc_codes, qcodes, col_weights, page,
                                       live, block=_CPU_BLOCK_D)
        return s, torch.clamp(i, max=d - 1)


def fused_phase1_quant(
    codes8: torch.Tensor,      # (d, n) int8 quantized rows
    scale: torch.Tensor,       # (d,) f32
    zero: torch.Tensor,        # (d,) f32
    queries: torch.Tensor,     # (Q, n) f32
    page: int,
    live: Optional[torch.Tensor] = None,   # (d,) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused int8 phase-1 -> (scores (Q, page) f32, ids (Q, page) int32),
    with ``page`` clamped to the doc count.  Candidate selection only:
    callers rescore the page against the exact fp32 vectors."""
    global quant_launches
    d, n = codes8.shape
    page = int(min(page, d))
    with cost.kernel_call("fused_phase1_quant", cost.quant_work(
            d, queries.shape[0], n, page, live is not None)):
        if codes8.is_cuda:
            out = kernel.fused_phase1_quant_cuda(codes8, scale, zero,
                                                 queries, page, live)
            with _lock:
                quant_launches += kernel.KERNELS_PER_CALL
            return out
        s, i = ref.fused_phase1_quant_stream(codes8, scale, zero, queries,
                                             page, live, block=_CPU_BLOCK_D)
        return s, torch.clamp(i, max=d - 1)
