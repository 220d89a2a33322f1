"""Phase-1 engines over the integer code matrix (beyond the paper).

A feature-token match is a per-column bucket equality, so the paper's
inverted-index score is

    score(q, d) = sum_j  w[q, j] * [qcodes[q, j] == doc_codes[d, j]]

Two plain lowerings (the reference's are plain jnp too, outside any
Pallas kernel):

* ``codes``  -- walk the (d, C) code matrix a doc block at a time and
  compare it with the (trimmed) query codes; the weighted sum over C is a
  float32 batched product of the {0, 1} match block with the weights.
* ``onehot`` -- expand codes into a {0, 1} matrix over the
  (column x bucket) token vocabulary and lower phase 1 to one float32
  matrix product ``Q1 @ D1.T`` per doc block: D1's columns are the
  posting lists.

Both are blocked over documents so that no (Q, d, C) tensor and no
(d, C * B) one-hot table exists.  Their float32 products need TF32 off on
the card (``torch.backends.cuda.matmul.allow_tf32 = False``); they agree
with the reference to float tolerance, not bits.
"""

from __future__ import annotations

import torch

__all__ = ["score_codes", "onehot_expand", "score_onehot"]

# elements of the per-block temporary of either engine: a (Q, block, C)
# match block, or a (block, C * B) one-hot block, stays a few hundred MB
_BLOCK_ELEMENTS = 1 << 26


def _block(per_doc: int) -> int:
    return max(1, _BLOCK_ELEMENTS // max(1, per_doc))


def score_codes(
    doc_codes: torch.Tensor,    # (d, C) int
    qcodes: torch.Tensor,       # (Q, C) int
    col_weights: torch.Tensor,  # (Q, C) f32, 0 where the token is filtered
) -> torch.Tensor:
    """Masked quantized-Hamming scores (Q, d), blocked over documents."""
    d = doc_codes.shape[0]
    Q, C = qcodes.shape
    out = torch.empty((Q, d), dtype=torch.float32, device=doc_codes.device)
    w = col_weights[:, :, None]                                # (Q, C, 1)
    for lo in range(0, d, _block(Q * C)):
        blk = doc_codes[lo:lo + _block(Q * C)]
        eq = (qcodes[:, None, :] == blk[None, :, :]).to(torch.float32)
        out[:, lo:lo + blk.shape[0]] = torch.bmm(eq, w)[..., 0]
    return out


def onehot_expand(codes: torch.Tensor, max_abs_bucket: int,
                  dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """(d, C) int codes -> (d, C * B) one-hot token matrix of ``dtype``.

    B = 2 * max_abs_bucket + 1 buckets per column; out-of-range codes clip
    to the boundary buckets (unit-normalised vectors never hit the clip)."""
    B = 2 * max_abs_bucket + 1
    d, C = codes.shape
    idx = torch.clamp(codes.to(torch.int64) + max_abs_bucket, 0, B - 1)
    idx += torch.arange(C, device=codes.device) * B
    out = torch.zeros((d, C * B), dtype=dtype, device=codes.device)
    return out.scatter_(1, idx, 1)


def score_onehot(
    doc_codes: torch.Tensor,    # (d, C) int
    qcodes: torch.Tensor,       # (Q, C) int
    col_weights: torch.Tensor,  # (Q, C) f32
    max_abs_bucket: int,
) -> torch.Tensor:
    """Phase-1 scores (Q, d) as a float32 matrix product over the one-hot
    token vocabulary, a doc block at a time."""
    B = 2 * max_abs_bucket + 1
    Q, C = qcodes.shape
    d = doc_codes.shape[0]
    q1 = onehot_expand(qcodes, max_abs_bucket, torch.float32)
    q1 = (q1.reshape(Q, C, B) * col_weights[..., None]).reshape(Q, C * B)
    out = torch.empty((Q, d), dtype=torch.float32, device=doc_codes.device)
    step = _block(C * B)
    for lo in range(0, d, step):
        d1 = onehot_expand(doc_codes[lo:lo + step], max_abs_bucket,
                           torch.float32)
        out[:, lo:lo + d1.shape[0]] = q1 @ d1.T
    return out
