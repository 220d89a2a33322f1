"""High-pass filters (paper §2.2.2): *trim* and *best*.

Both produce a boolean *feature mask* over the original feature axis;
:func:`expand_mask` tiles it to an encoder's code-column axis (identity for
single encoders, a 2x tile for :class:`~repro_torch.core.encoding.
CombinedEncoder`).  Filters apply to the query (choosable per request) and,
for ``best``, optionally to the index at build time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

__all__ = ["TrimFilter", "BestFilter", "Filter", "feature_mask", "expand_mask",
           "index_best_codes"]


@dataclasses.dataclass(frozen=True)
class TrimFilter:
    """Keep features with ``|x_j| >= threshold`` (paper: 0.05 / 0.10 / 0.20)."""

    threshold: float = 0.05

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.abs(x) >= self.threshold


@dataclasses.dataclass(frozen=True)
class BestFilter:
    """Keep only the ``m`` features with the largest ``|x_j|``."""

    m: int = 90

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-1]
        if self.m >= n:
            return torch.ones(x.shape, dtype=torch.bool, device=x.device)
        a = torch.abs(x)
        kth = torch.sort(a, dim=-1).values[..., n - self.m]
        keep = a >= kth[..., None]
        # ties can leave more than m survivors: drop the lowest-ranked
        # extras (rank by magnitude, then by index) so |mask| == m exactly
        rank = torch.argsort(torch.argsort(-a, dim=-1, stable=True), dim=-1,
                             stable=True)
        return keep & (rank < self.m)


Filter = Union[TrimFilter, BestFilter]


def feature_mask(
    x: torch.Tensor,
    trim: Optional[TrimFilter] = None,
    best: Optional[BestFilter] = None,
) -> torch.Tensor:
    """Combined boolean mask on the feature axis (AND of the active filters)."""
    m = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    if trim is not None:
        m = m & trim.mask(x)
    if best is not None:
        m = m & best.mask(x)
    return m


def index_best_codes(vectors: torch.Tensor, codes: torch.Tensor, m: int,
                     sentinel: int) -> torch.Tensor:
    """Index-side *best* filter: code columns of non-best features take the
    never-matching ``sentinel`` code, dropping them from every posting list."""
    mask = expand_mask(feature_mask(vectors, best=BestFilter(m)),
                       codes.shape[-1])
    return torch.where(mask, codes,
                       torch.tensor(sentinel, dtype=codes.dtype,
                                    device=codes.device))


def expand_mask(mask: torch.Tensor, n_columns: int) -> torch.Tensor:
    """Tile a feature mask to an encoder's code-column axis."""
    n = mask.shape[-1]
    if n_columns == n:
        return mask
    if n_columns % n != 0:
        raise ValueError(f"n_columns={n_columns} not a multiple of n={n}")
    return torch.cat([mask] * (n_columns // n), dim=-1)
