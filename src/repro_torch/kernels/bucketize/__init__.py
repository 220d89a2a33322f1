"""Bucketize kernel: fused row normalize + quantize, at build and ingest."""

from .ops import bucketize, encode
from .ref import bucketize_ref

__all__ = ["bucketize", "encode", "bucketize_ref"]
