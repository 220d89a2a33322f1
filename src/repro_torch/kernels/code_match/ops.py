"""Public wrapper of the code-match kernel.

``code_match`` writes the full (Q, d) matrix of weighted code-equality
scores (the ``codes_pallas`` engine's phase 1).  A CUDA tensor goes to the
hand-written kernel (:mod:`.kernel`) or raises; a CPU tensor goes to the
plain version (:func:`.ref.code_match_ref`), a doc block at a time so that
the (Q, block, C) select stays near ``_CPU_ELEMENTS`` elements.

``launches`` counts the CUDA kernels this wrapper launched, one per call
on the card.  Calls made straight to :func:`.kernel.code_match_cuda`, as a
comparison with the plain version does, are not counted.
"""

from __future__ import annotations

import torch

from . import kernel, ref

__all__ = ["code_match", "launches"]

launches = 0

_CPU_ELEMENTS = 1 << 24


def code_match(
    doc_codes: torch.Tensor,    # (d, C) int
    qcodes: torch.Tensor,       # (Q, C) int
    col_weights: torch.Tensor,  # (Q, C) f32
) -> torch.Tensor:
    """(Q, d) f32 weighted code-equality scores."""
    global launches
    if doc_codes.is_cuda:
        out = kernel.code_match_cuda(doc_codes, qcodes, col_weights)
        launches += kernel.KERNELS_PER_CALL
        return out
    Q, C = qcodes.shape
    block = max(1, _CPU_ELEMENTS // max(1, Q * C))
    d = doc_codes.shape[0]
    out = torch.empty((Q, d), dtype=torch.float32, device=doc_codes.device)
    for lo in range(0, d, block):
        out[:, lo:lo + block] = ref.code_match_ref(doc_codes[lo:lo + block],
                                                   qcodes, col_weights)
    return out
