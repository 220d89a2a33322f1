"""Public wrapper of the code-match kernel.

``code_match`` writes the full (Q, d) matrix of weighted code-equality
scores (the ``codes_pallas`` engine's phase 1).  A CUDA tensor goes to the
hand-written kernel (:mod:`.kernel`) or raises; a CPU tensor goes to the
plain version (:func:`.ref.code_match_ref`), a doc block at a time so that
the (Q, block, C) select stays near ``_CPU_ELEMENTS`` elements.

``launches`` counts the CUDA kernels this wrapper launched, one per call
on the card.  Calls made straight to :func:`.kernel.code_match_cuda`, as a
comparison with the plain version does, are not counted.  The count is
guarded by a lock: batchers on several threads launch at once.  Each call,
on either path, first files its work as a cost row
(:func:`repro_torch.obs.cost.kernel_call`).
"""

from __future__ import annotations

import threading

import torch

from repro_torch.obs import cost

from . import kernel, ref

__all__ = ["code_match", "launches"]

launches = 0
_lock = threading.Lock()

_CPU_ELEMENTS = 1 << 24


def code_match(
    doc_codes: torch.Tensor,    # (d, C) int
    qcodes: torch.Tensor,       # (Q, C) int
    col_weights: torch.Tensor,  # (Q, C) f32
) -> torch.Tensor:
    """(Q, d) f32 weighted code-equality scores."""
    global launches
    with cost.kernel_call("code_match", cost.code_match_work(
            doc_codes.shape[0], qcodes.shape[0], qcodes.shape[1],
            doc_codes.element_size())):
        if doc_codes.is_cuda:
            out = kernel.code_match_cuda(doc_codes, qcodes, col_weights)
            with _lock:
                launches += kernel.KERNELS_PER_CALL
            return out
        Q, C = qcodes.shape
        block = max(1, _CPU_ELEMENTS // max(1, Q * C))
        d = doc_codes.shape[0]
        out = torch.empty((Q, d), dtype=torch.float32,
                          device=doc_codes.device)
        for lo in range(0, d, block):
            out[:, lo:lo + block] = ref.code_match_ref(
                doc_codes[lo:lo + block], qcodes, col_weights)
        return out
