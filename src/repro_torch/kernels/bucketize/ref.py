"""Plain PyTorch version of the bucketize kernel.

Normalize each row (``x / max(||x||, 1e-12)``), then quantize: rounding
half away from zero of ``x * param`` (``mode="round"``, param = scale) or
``floor(x / param)`` (``mode="floor"``, param = width), cast to
``out_dtype``.  The interval division divides by a float32 tensor on the
input's device: PyTorch's CUDA ``div`` by a Python scalar computes
``x * (1 / param)``, which moves codes at bucket edges.
"""

from __future__ import annotations

import torch

from repro_torch.core.rerank import normalize

__all__ = ["bucketize_ref"]


def bucketize_ref(x: torch.Tensor, mode: str, param: float,
                  out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """(B, n) raw rows -> (B, n) codes of ``out_dtype``."""
    x = normalize(x.to(torch.float32))
    if mode == "round":
        scaled = x * param
        b = torch.sign(scaled) * torch.floor(torch.abs(scaled) + 0.5)
    elif mode == "floor":
        b = torch.floor(x / torch.tensor(param, dtype=torch.float32,
                                         device=x.device))
    else:
        raise ValueError(mode)
    return b.to(out_dtype)
