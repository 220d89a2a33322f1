"""Public wrapper of the fused phase-1 kernel.

``fused_phase1`` scores every document by weighted code matches and keeps
the top-``page`` in one pass, with no (Q, d) score matrix.  A CUDA tensor
goes to the hand-written kernel (:mod:`.kernel`) or raises; a CPU tensor
goes to the plain version (:func:`.ref.fused_phase1_stream`, folding the
doc axis in tiles of 512).  Both are bit-equal to the composed reference
in scores, and equal in ids wherever the score is finite.

Contract for -inf slots: when fewer than ``page`` docs are live, the
trailing -inf slots carry an unspecified but in-range doc id.

``launches`` counts the CUDA kernels this wrapper launched: each call on
the card launches two, ``score_fold_kernel`` and ``merge_splits_kernel``
(:data:`.kernel.KERNELS_PER_CALL`).  Calls made straight to
:func:`.kernel.fused_phase1_cuda`, as a comparison with the plain version
does, are not counted.  A run resets it to 0 to show that a path went
through the kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel, ref

__all__ = ["fused_phase1", "launches"]

launches = 0

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
    d = doc_codes.shape[0]
    page = int(min(page, d))
    if doc_codes.is_cuda:
        out = kernel.fused_phase1_cuda(doc_codes, qcodes, col_weights, page,
                                       live)
        launches += kernel.KERNELS_PER_CALL
        return out
    s, i = ref.fused_phase1_stream(doc_codes, qcodes, col_weights, page,
                                   live, block=_CPU_BLOCK_D)
    return s, torch.clamp(i, max=d - 1)
