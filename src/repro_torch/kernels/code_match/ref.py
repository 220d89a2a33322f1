"""Plain PyTorch version of the code-match kernel.

``out[q, d] = sum_c w[q, c] * [qcodes[q, c] == doc_codes[d, c]]``: select
the matching weights, then one sum over C.  The CUDA kernel sums through
the ``match_scores`` tree instead (bit-equal to
:func:`repro_torch.kernels.fused_phase1.ref.match_scores`), so the two
agree to float tolerance, as the reference's kernel and its oracle do.
"""

from __future__ import annotations

import torch

__all__ = ["code_match_ref"]


def code_match_ref(
    doc_codes: torch.Tensor,    # (d, C) int
    qcodes: torch.Tensor,       # (Q, C) int
    col_weights: torch.Tensor,  # (Q, C) f32
) -> torch.Tensor:
    """(Q, d) f32 code-match scores, through a (Q, d, C) select."""
    eq = qcodes[:, None, :] == doc_codes[None, :, :]
    return torch.where(eq, col_weights[:, None, :], 0.0).sum(dim=-1)
