"""Launcher of the hand-written CUDA bucketize kernel
(``csrc/bucketize.cu``, which replaces the TPU kernel
``src/repro/kernels/bucketize/kernel.py::bucketize_pallas``).

The kernel allocates nothing: this module checks its input, allocates the
(B, n) codes with ``torch.empty`` on the input's device, and launches on
PyTorch's current stream.  Any row count runs (no padding).  It raises on
anything the kernel does not take, and when the launch reports a CUDA
error.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build

__all__ = ["bucketize_cuda", "KERNELS_PER_CALL", "MODES", "library"]

KERNELS_PER_CALL = 1       # bucketize_kernel

MODES = {"round": 0, "floor": 1}
_SOURCES = (pathlib.Path(__file__).parent / "csrc" / "bucketize.cu",)
_ENTRY = {torch.int8: "bucketize_int8", torch.int16: "bucketize_int16"}
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                          ctypes.c_void_p]


def library() -> ctypes.CDLL:
    """The built kernel library (nvcc at first use, then cached)."""
    lib = _build.load_library("bucketize", _SOURCES)
    for fn in _ENTRY.values():
        getattr(lib, fn).argtypes = _ARGTYPES
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def bucketize_cuda(x: torch.Tensor, mode: str, param: float,
                   out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Launch the kernel on (B, n) float32 rows -> (B, n) codes."""
    if x.device.type != "cuda":
        raise ValueError(f"bucketize kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if out_dtype not in _ENTRY:
        raise TypeError(f"out_dtype {out_dtype} not supported (int8, "
                        f"int16)")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if x.dim() != 2:
        raise ValueError("x must be 2-D (B, n)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    B, n = x.shape
    if B < 1 or n < 1:
        raise ValueError(f"empty input: B={B}, n={n}")
    if B >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} does not fit int32")
    out = torch.empty((B, n), dtype=out_dtype, device=x.device)
    fn = getattr(library(), _ENTRY[out_dtype])
    with _build.launch_record("bucketize"):
        err = fn(x.data_ptr(), out.data_ptr(), B, n, MODES[mode],
                 float(param), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bucketize kernel launch failed: CUDA error "
                           f"{err}")
    return out
