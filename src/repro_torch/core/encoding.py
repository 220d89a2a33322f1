"""Vector -> integer-code encoders (paper §2.2.1).

A feature token is the pair (column j, bucket b), where ``b`` is an integer
quantization of the feature value.  Three encoders mirror the paper:

* :class:`RoundingEncoder`  -- ``P<p>``: round to ``p`` decimals.
* :class:`IntervalEncoder`  -- ``I<1/w>``: floor-quantize into width-``w`` bins.
* :class:`CombinedEncoder`  -- both token sets, codes concatenated along the
  column axis (columns ``[0, n)`` rounding, ``[n, 2n)`` interval).

Every encoder maps ``x : (..., n) float32`` -> ``codes : (..., n_columns)``
in the smallest signed integer dtype that holds the bucket range for
unit-normalised inputs (int8 for the paper's default settings).

Two arithmetic details keep the codes integer-exact against the reference:
rounding is half-away-from-zero (``sign(s) * floor(|s| + 0.5)``, not
``torch.round``'s half-to-even), and the interval division (and
``decode_center``'s) divides by a float32 tensor on the input's device --
PyTorch's CUDA ``div`` by a Python scalar computes ``a * (1 / b)``, which
moves codes at bucket edges.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Union

import torch

__all__ = [
    "RoundingEncoder",
    "IntervalEncoder",
    "CombinedEncoder",
    "Encoder",
    "smallest_int_dtype",
]


def _f32(value: float, device) -> torch.Tensor:
    """``value`` as a float32 tensor on ``device``: the divisor (or factor)
    of an elementwise op, never a Python scalar (see module doc)."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def smallest_int_dtype(max_abs: int) -> torch.dtype:
    """Smallest signed integer dtype holding values in [-max_abs, max_abs]."""
    if max_abs <= 127:
        return torch.int8
    if max_abs <= 32767:
        return torch.int16
    return torch.int32


@dataclasses.dataclass(frozen=True)
class RoundingEncoder:
    """Paper's *rounding* scheme ``P<precision>``: ``round(x * 10**p)``,
    half away from zero (0.065 -> 7 at p=2)."""

    precision: int = 2

    @property
    def scale(self) -> int:
        return 10 ** self.precision

    @property
    def scheme_id(self) -> str:
        return f"P{self.precision}"

    @property
    def max_abs_bucket(self) -> int:
        return self.scale           # unit-normalised features are in [-1, 1]

    @property
    def code_dtype(self) -> torch.dtype:
        return smallest_int_dtype(self.max_abs_bucket)

    def n_columns(self, n_features: int) -> int:
        return n_features

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        scaled = x * self.scale
        b = torch.sign(scaled) * torch.floor(torch.abs(scaled) + 0.5)
        return b.to(self.code_dtype)

    def column_feature(self, n_features: int) -> torch.Tensor:
        """Original feature index of every code column."""
        return torch.arange(n_features)

    def decode_center(self, codes: torch.Tensor) -> torch.Tensor:
        """Representative value of a bucket (for reconstruction tests)."""
        return codes.to(torch.float32) / _f32(self.scale, codes.device)


@dataclasses.dataclass(frozen=True)
class IntervalEncoder:
    """Paper's *interval* scheme ``I<round(1/width)>``: ``floor(x / width)``
    (width 0.1 maps 0.12 -> 1, -0.13 -> -2)."""

    width: float = 0.1

    @property
    def scheme_id(self) -> str:
        return f"I{round(1.0 / self.width)}"

    @property
    def max_abs_bucket(self) -> int:
        return math.ceil(1.0 / self.width) + 1

    @property
    def code_dtype(self) -> torch.dtype:
        return smallest_int_dtype(self.max_abs_bucket)

    def n_columns(self, n_features: int) -> int:
        return n_features

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        # a float32 tensor divisor, never a Python scalar: see module doc
        return torch.floor(x / _f32(self.width, x.device)).to(self.code_dtype)

    def column_feature(self, n_features: int) -> torch.Tensor:
        return torch.arange(n_features)

    def decode_center(self, codes: torch.Tensor) -> torch.Tensor:
        return (codes.to(torch.float32) + 0.5) * _f32(self.width, codes.device)


@dataclasses.dataclass(frozen=True)
class CombinedEncoder:
    """Paper's *combined* scheme: rounding and interval tokens together."""

    rounding: RoundingEncoder = RoundingEncoder(3)
    interval: IntervalEncoder = IntervalEncoder(0.2)

    @property
    def scheme_id(self) -> str:
        return f"{self.rounding.scheme_id}+{self.interval.scheme_id}"

    @property
    def max_abs_bucket(self) -> int:
        return max(self.rounding.max_abs_bucket, self.interval.max_abs_bucket)

    @property
    def code_dtype(self) -> torch.dtype:
        return smallest_int_dtype(self.max_abs_bucket)

    def n_columns(self, n_features: int) -> int:
        return 2 * n_features

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.code_dtype
        r = self.rounding.encode(x).to(dt)
        i = self.interval.encode(x).to(dt)
        return torch.cat([r, i], dim=-1)

    def column_feature(self, n_features: int) -> torch.Tensor:
        f = torch.arange(n_features)
        return torch.cat([f, f])

    def decode_center(self, codes: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("combined codes have no single center")


Encoder = Union[RoundingEncoder, IntervalEncoder, CombinedEncoder]
