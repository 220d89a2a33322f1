"""Materialize paper-format string feature tokens (paper §2.2.1).

Only used for interop (feeding a real fulltext engine) and for tests that pin
the exact examples from the paper; all internal engines operate on integer
codes.  Codes and masks come from this package's encoders and filters on
a float32 CPU tensor, so the strings equal the JAX package's.  Token
grammar (no special characters, per the paper's footnote 1):

    <feature><scheme><value>
    value   := 'i' ['neg'] digits ['d' digits]     # 'd' is the decimal point

Examples from the paper, all reproduced by the tests:

* rounding P2 of [0.12, -0.13, 0.065] -> ['0P2i0d12', '1P2ineg0d13', '2P2i0d07']
* interval I10 of the same          -> ['0I10i0d1', '1I10ineg0d2', '2I10i0d0']
* combined P3+I5                    -> ['0P3i0d120', '1P3ineg0d130',
                                        '2P3i0d065', '0I5i0d0',
                                        '1I5ineg0d2', '2I5i0d0']
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .encoding import CombinedEncoder, Encoder, IntervalEncoder, RoundingEncoder
from .filtering import BestFilter, TrimFilter, feature_mask

__all__ = ["encode_value", "tokens_for_vector", "token"]


def encode_value(text: str) -> str:
    """'0.12' -> 'i0d12'; '-0.2' -> 'ineg0d2' (paper's sign/point escaping)."""
    out = text
    neg = out.startswith("-")
    if neg:
        out = out[1:]
    out = out.replace(".", "d")
    return "i" + ("neg" if neg else "") + out


def _strip_trailing_zeros(text: str) -> str:
    """Strip trailing zeros but keep at least one fractional digit
    (the paper prints the 0.0 interval start as 'd0', e.g. '2I10i0d0')."""
    if "." in text:
        text = text.rstrip("0")
        if text.endswith("."):
            text += "0"
    if text in ("-0.0", "-0"):
        text = "0.0"
    return text


def _interval_start_str(bucket: int, width: float) -> str:
    # bucket b covers [b*width, (b+1)*width); the paper names the interval by
    # its start, printed minimally ('0d1' for 0.1, '0d0' for 0.0).
    start = bucket * width
    # avoid float noise: print with enough decimals then strip
    txt = _strip_trailing_zeros(f"{start:.6f}")
    return txt


def token(feature: int, scheme_id: str, value_text: str) -> str:
    return f"{feature}{scheme_id}{encode_value(value_text)}"


def tokens_for_vector(
    x: np.ndarray,
    encoder: Encoder,
    trim: Optional[TrimFilter] = None,
    best: Optional[BestFilter] = None,
) -> List[str]:
    """Paper-format tokens for one vector, with optional high-pass filtering."""
    x = torch.as_tensor(x, dtype=torch.float32).cpu()
    if x.ndim != 1:
        raise ValueError("tokens_for_vector expects a single vector")
    mask = feature_mask(x, trim=trim, best=best).numpy()

    if isinstance(encoder, CombinedEncoder):
        return tokens_for_vector(x, encoder.rounding, trim, best) + tokens_for_vector(
            x, encoder.interval, trim, best
        )

    out: List[str] = []
    if isinstance(encoder, RoundingEncoder):
        codes = encoder.encode(x).numpy().astype(np.int64)
        for j in range(x.shape[0]):
            if not mask[j]:
                continue
            val = codes[j] / encoder.scale
            out.append(token(j, encoder.scheme_id, f"{val:.{encoder.precision}f}"))
    elif isinstance(encoder, IntervalEncoder):
        codes = encoder.encode(x).numpy().astype(np.int64)
        for j in range(x.shape[0]):
            if not mask[j]:
                continue
            out.append(
                token(j, encoder.scheme_id, _interval_start_str(int(codes[j]), encoder.width))
            )
    else:  # pragma: no cover
        raise TypeError(f"unknown encoder {encoder!r}")
    return out
