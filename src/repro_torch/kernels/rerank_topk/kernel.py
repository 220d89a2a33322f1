"""Launcher of the hand-written CUDA rerank kernel
(``csrc/rerank_topk.cu``, which replaces the TPU kernel
``src/repro/kernels/rerank_topk/kernel.py::rerank_scores_pallas``).

The kernel gathers the candidate rows itself: it takes the (d, n) table,
the (Q, P) int32 ids and the (Q, n) queries.  It allocates nothing: this
module checks the inputs, allocates the (Q, P) scores with ``torch.empty``
on the input's device, and launches on PyTorch's current stream.  It
raises on anything the kernel does not take, and when the launch reports
a CUDA error.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build

__all__ = ["rerank_scores_cuda", "KERNELS_PER_CALL", "library"]

KERNELS_PER_CALL = 1       # rerank_scores_kernel

_SOURCES = (pathlib.Path(__file__).parent / "csrc" / "rerank_topk.cu",)


def library() -> ctypes.CDLL:
    """The built kernel library (nvcc at first use, then cached)."""
    lib = _build.load_library("rerank_topk", _SOURCES)
    lib.rerank_scores.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                  + [ctypes.c_void_p] * 2)
    lib.rerank_scores.restype = ctypes.c_int
    lib.rerank_scores_smem_bytes.argtypes = [ctypes.c_int]
    lib.rerank_scores_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(table, ids, queries):
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"rerank kernel needs CUDA tensors, got {dev}")
    for name, t in (("ids", ids), ("queries", queries)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, table on {dev}")
    for name, t in (("table", table), ("queries", queries)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if table.dim() != 2 or ids.dim() != 2 or queries.dim() != 2:
        raise ValueError("table (d, n), ids (Q, P) and queries (Q, n) must "
                         "be 2-D")
    d, n = table.shape
    Q, P = ids.shape
    if queries.shape != (Q, n):
        raise ValueError(f"shape mismatch: table {tuple(table.shape)}, ids "
                         f"{tuple(ids.shape)}, queries "
                         f"{tuple(queries.shape)}")
    for name, t in (("table", table), ("ids", ids), ("queries", queries)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d < 1 or Q < 1 or P < 1 or n < 1:
        raise ValueError(f"empty input: d={d}, Q={Q}, P={P}, n={n}")
    if d >= 2 ** 31 or P >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"d={d}, P={P}, n={n} do not fit int32")


def rerank_scores_cuda(table: torch.Tensor, ids: torch.Tensor,
                       queries: torch.Tensor) -> torch.Tensor:
    """Launch the kernel -> (Q, P) f32 scores of the rows ``table[ids]``
    against their queries (ids clamped to [0, d))."""
    _check(table, ids, queries)
    dev = table.device
    d, n = table.shape
    Q, P = ids.shape
    lib = library()
    smem_max = _build.smem_optin(torch.cuda.get_device_properties(dev))
    if lib.rerank_scores_smem_bytes(n) > smem_max:
        raise ValueError(f"a query row of n={n} floats does not fit the "
                         f"card's {smem_max} B of shared memory")
    out = torch.empty((Q, P), dtype=torch.float32, device=dev)
    err = lib.rerank_scores(table.data_ptr(), ids.data_ptr(),
                            queries.data_ptr(), d, Q, P, n, out.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rerank kernel launch failed: CUDA error {err}")
    return out
