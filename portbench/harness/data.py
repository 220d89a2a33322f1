"""Inputs made from the seed, on the device, in a few large calls: the
corpus, the appended bulks and the queries.

Rows are Gaussian, normalised to unit length in float32, then moved a
hair (``margin``) off every rounding-encoder bucket edge and off the trim
threshold.  So any float32 normalisation of the same rows, however its
sums are ordered, gives the same codes and the same trim mask, and the
program and the reference see one set of tokens.  The shift is at most
``2 * margin`` on a few hundredths of a percent of the values.
"""

from __future__ import annotations

import torch

_CHUNK = 1 << 18


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def normalize32(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def snap(x: torch.Tensor, precision: int, trim, margin: float
         ) -> torch.Tensor:
    """``x`` with every value at least ``margin`` from a bucket edge
    ``(j + 1/2) / 10**precision`` and from ``+-trim``."""
    s = float(10 ** precision)
    y = x.to(torch.float64) * s
    edge = torch.round(y - 0.5) + 0.5
    d = y - edge
    m = margin * s
    side = torch.where(d >= 0, 1.0, -1.0).to(torch.float64)
    y = torch.where(d.abs() < m, edge + side * m, y)
    v = y / s
    if trim is not None:
        a = v.abs()
        t = torch.where(a >= trim, trim + margin, trim - margin)
        v = torch.where((a - trim).abs() < margin, torch.sign(v) * t, v)
    return v.to(torch.float32)


def unit_rows(n_rows: int, n_feat: int, g: torch.Generator, device,
              precision: int, trim, margin: float) -> torch.Tensor:
    """(n_rows, n_feat) snapped unit rows: one ``randn`` call, then
    normalised and snapped in place a block at a time."""
    x = torch.randn((n_rows, n_feat), generator=g, device=device)
    for r in range(0, n_rows, _CHUNK):
        x[r:r + _CHUNK] = snap(normalize32(x[r:r + _CHUNK]), precision,
                               trim, margin)
    return x


def noisy_copies(rows: torch.Tensor, noise: float, g: torch.Generator,
                 precision: int, trim, margin: float) -> torch.Tensor:
    """Queries "more like" the given rows: each row plus Gaussian noise of
    scale ``noise`` per feature, normalised and snapped."""
    out = torch.empty_like(rows)
    for r in range(0, rows.shape[0], _CHUNK):
        x = rows[r:r + _CHUNK]
        x = x + noise * torch.randn(x.shape, generator=g, device=x.device)
        out[r:r + _CHUNK] = snap(normalize32(x), precision, trim, margin)
    return out
