"""Gradient compression for cross-pod data parallelism.

The JAX package's ``train/compression.py`` in PyTorch.  Two composable
schemes:

* **top-k sparsification with error feedback** (Deep Gradient Compression
  style): only the k largest-magnitude entries of a leaf are exchanged;
  the residual is carried in an error-feedback buffer, so the compression
  is unbiased over time.  Ties in magnitude go to the lower flat index,
  as ``jax.lax.top_k``'s do.
* **int8 quantization** with a per-leaf symmetric scale, rounded half to
  even (``torch.round``, as ``jnp.round``): bit-equal to the reference's.

``compressed_psum`` is the reference's int8 all-reduce.  One process has
no axis to reduce over, so it takes every participant's gradient and
returns what each would hold after the reference's psum.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Sequence, Tuple

import torch

from ..models.common import div

__all__ = ["TopK", "topk_compress", "topk_decompress", "int8_quantize",
           "int8_dequantize", "ef_topk_step", "compressed_psum"]


class TopK(NamedTuple):
    values: torch.Tensor   # (k,)
    indices: torch.Tensor  # (k,) int32 into the flattened leaf
    shape: Any


def topk_compress(g: torch.Tensor, ratio: float) -> TopK:
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * ratio))
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return TopK(values=flat[idx], indices=idx.to(torch.int32),
                shape=tuple(g.shape))


def topk_decompress(c: TopK) -> torch.Tensor:
    size = math.prod(c.shape)
    flat = torch.zeros((size,), dtype=c.values.dtype, device=c.values.device)
    flat[c.indices.long()] = c.values
    return flat.reshape(c.shape)


def ef_topk_step(g: torch.Tensor, err: torch.Tensor, ratio: float):
    """Error-feedback top-k: -> (sparse_grad_dense, new_err).

    sparse + err' == g + err exactly (nothing is lost, only delayed)."""
    corrected = g + err
    sparse = topk_decompress(topk_compress(corrected, ratio))
    return sparse, corrected - sparse


def int8_quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = div(torch.clamp(g.abs().max(), min=1e-12), 127.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(gs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The reference's int8-quantized all-reduce over the participants
    whose gradients are ``gs`` (one each; the axis of ``psum`` is this
    sequence): each quantizes its own gradient, the int8 payloads are
    summed in int32 (no overflow), the scales meaned.  -> the f32 tensor
    every participant holds afterwards, the int32 sum times the mean
    scale.  Bytes on the wire in the reference: 1/4 of f32, plus one
    scalar a leaf."""
    qs, scales = zip(*(int8_quantize(g) for g in gs))
    q_sum = torch.stack([q.to(torch.int32) for q in qs]).sum(0)
    scale_mean = div(torch.stack(scales).sum(), float(len(gs)))
    return q_sum.float() * scale_mean
