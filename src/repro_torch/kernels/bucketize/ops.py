"""Public wrapper of the bucketize kernel: encoder-aware fused encode.

``encode(x, encoder)`` equals ``encoder.encode(normalize(x))`` (the
reference suite's contract: >= 99.99% of codes equal, the rest one bucket
off, from the norm's reduction order) in one pass over the raw rows.  A
CUDA tensor goes to the hand-written kernel (:mod:`.kernel`) or raises; a
CPU tensor goes to the plain version (:func:`.ref.bucketize_ref`).

``launches`` counts the CUDA kernels this wrapper launched: one per
encoder half (two for a ``CombinedEncoder``).  Calls made straight to
:func:`.kernel.bucketize_cuda`, as a comparison with the plain version
does, are not counted.  The count is guarded by a lock: batchers on
several threads launch at once.  Each call, on either path, first files
its work as a cost row (:func:`repro_torch.obs.cost.kernel_call`).
"""

from __future__ import annotations

import threading

import torch

from repro_torch.core.encoding import (CombinedEncoder, Encoder,
                                       IntervalEncoder, RoundingEncoder)
from repro_torch.obs import cost

from . import kernel, ref

__all__ = ["bucketize", "encode", "launches"]

launches = 0
_lock = threading.Lock()


def bucketize(x: torch.Tensor, mode: str, param: float,
              out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Fused normalize + quantize of (B, n) rows under one mode."""
    global launches
    with cost.kernel_call("bucketize", cost.bucketize_work(
            x.shape[0], x.shape[-1], out_dtype.itemsize)):
        if x.is_cuda:
            out = kernel.bucketize_cuda(x, mode, param, out_dtype)
            with _lock:
                launches += kernel.KERNELS_PER_CALL
            return out
        return ref.bucketize_ref(x, mode, param, out_dtype)


def encode(x: torch.Tensor, encoder: Encoder) -> torch.Tensor:
    """Fused normalize + encode; matches ``encoder.encode(normalize(x))``."""
    dt = encoder.code_dtype
    if isinstance(encoder, RoundingEncoder):
        return bucketize(x, "round", float(encoder.scale), dt)
    if isinstance(encoder, IntervalEncoder):
        return bucketize(x, "floor", float(encoder.width), dt)
    if isinstance(encoder, CombinedEncoder):
        r = encode(x, encoder.rounding).to(dt)
        i = encode(x, encoder.interval).to(dt)
        return torch.cat([r, i], dim=-1)
    raise TypeError(f"unknown encoder {encoder!r}")
