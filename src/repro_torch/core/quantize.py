"""Per-row int8 scalar quantization of the dense vector table.

Phase-1 candidate selection of the ``fused_int8`` engine runs against an
int8 copy of the (d, n) vector table -- a quarter of the bytes -- while the
final page is always rescored against the exact fp32 vectors
(:mod:`repro_torch.core.rerank`), so quantization can change which
candidates reach the rescore, never the reported score of a hit.

Scheme: asymmetric per-row affine quantization.  For each row ``v``::

    zero  = (max(v) + min(v)) / 2
    scale = max(max(v) - min(v), eps) / 254
    q     = clip(round((v - zero) / scale), -127, 127)  int8

``round`` is half to even, as ``torch.round`` and ``jnp.round`` both
round.  A row quantizes to the same bits alone or inside any table, and the
table is bit-equal to the JAX reference's ``quantize_rows``.  Both
divisions divide by float32 tensors on the input's device: PyTorch's CUDA
``div`` by a Python scalar computes ``a * (1 / b)``, which would move the
scale by an ulp on the card.

The phase-1 score against the dequantized rows never builds them::

    q . (a * scale + zero) = scale * (q . a) + zero * sum(q)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["QMAX", "QuantizedTable", "quantize_rows", "dequantize_rows",
           "quantize_table", "quantized_scores"]

QMAX = 127          # symmetric int8 code range [-127, 127]
_EPS = 1e-8         # degenerate (constant) rows get this range

# rows quantized per step by quantize_table: the f32 temporaries then stay
# a few hundred MB at paper scale
_ROWS = 1 << 18


def quantize_rows(v: torch.Tensor, eps: float = _EPS
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize ``(..., n)`` f32 rows -> (codes int8, scale, zero), with
    ``scale`` and ``zero`` of shape ``(...,)``: one pair per row."""
    v = torch.as_tensor(v, dtype=torch.float32)
    lo = torch.amin(v, dim=-1, keepdim=True)
    hi = torch.amax(v, dim=-1, keepdim=True)
    zero = (hi + lo) * 0.5
    span = torch.tensor(2.0 * QMAX, dtype=torch.float32, device=v.device)
    scale = torch.clamp(hi - lo, min=eps) / span
    q = torch.clamp(torch.round((v - zero) / scale), -QMAX, QMAX)
    return q.to(torch.int8), scale[..., 0], zero[..., 0]


def dequantize_rows(codes: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor) -> torch.Tensor:
    """Reconstruct f32 rows; per-element error ``<= scale / 2`` per row."""
    return codes.to(torch.float32) * scale[..., None] + zero[..., None]


@dataclasses.dataclass
class QuantizedTable:
    """int8 copy of a (d, n) vector table + per-row affine params."""

    codes: torch.Tensor    # (d, n) int8
    scale: torch.Tensor    # (d,) f32
    zero: torch.Tensor     # (d,) f32

    @property
    def nbytes_codes(self) -> int:
        return self.codes.numel()  # int8: one byte per element


def quantize_table(vectors: torch.Tensor) -> QuantizedTable:
    """:func:`quantize_rows` over a (d, n) table, ``_ROWS`` rows a step."""
    d, n = vectors.shape
    dev = vectors.device
    codes = torch.empty((d, n), dtype=torch.int8, device=dev)
    scale = torch.empty((d,), dtype=torch.float32, device=dev)
    zero = torch.empty((d,), dtype=torch.float32, device=dev)
    for r in range(0, d, _ROWS):
        codes[r:r + _ROWS], scale[r:r + _ROWS], zero[r:r + _ROWS] = \
            quantize_rows(vectors[r:r + _ROWS])
    return QuantizedTable(codes, scale, zero)


def quantized_scores(
    codes: torch.Tensor,      # (d, n) int8
    scale: torch.Tensor,      # (d,) f32
    zero: torch.Tensor,       # (d,) f32
    queries: torch.Tensor,    # (Q, n) f32
    qsum: Optional[torch.Tensor] = None,  # (Q, 1) sum(queries, -1)
) -> torch.Tensor:
    """(Q, d) phase-1 scores against the dequantized rows, as
    ``scale * (codes . query) + zero * sum(query)``: the plain version of
    the ``fused_int8`` engine's scorer.  A float32 product: on the card it
    needs TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    if qsum is None:
        qsum = queries.sum(dim=-1, keepdim=True)
    raw = queries @ codes.to(torch.float32).T
    return raw * scale[None, :] + qsum * zero[None, :]
