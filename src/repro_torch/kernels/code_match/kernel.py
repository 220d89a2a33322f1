"""Launcher of the hand-written CUDA code-match kernel
(``csrc/code_match.cu``, which replaces the TPU kernel
``src/repro/kernels/code_match/kernel.py::code_match_pallas``).

The kernel allocates nothing: this module checks its inputs, sizes the
launch (query tile, staged rows, doc chunks) against the card, allocates
the (Q, d) output with ``torch.empty`` on the input's device, and launches
on PyTorch's current stream.  It raises on anything the kernel does not
take, and when the launch reports a CUDA error.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build

__all__ = ["code_match_cuda", "KERNELS_PER_CALL", "library"]

KERNELS_PER_CALL = 1       # code_match_kernel

_BLOCKS_PER_SM = 8         # doc chunks aim at this many blocks per SM

_SOURCES = (pathlib.Path(__file__).parent / "csrc" / "code_match.cu",
            pathlib.Path(__file__).parents[1] / "csrc" / "match_tree.cuh")
_ENTRY = {torch.int8: "code_match_int8", torch.int16: "code_match_int16",
          torch.int32: "code_match_int32"}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2


def library() -> ctypes.CDLL:
    """The built kernel library (nvcc at first use, then cached)."""
    lib = _build.load_library("code_match", _SOURCES)
    for fn in _ENTRY.values():
        getattr(lib, fn).argtypes = _ARGTYPES
        getattr(lib, fn).restype = ctypes.c_int
    lib.code_match_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.code_match_smem_bytes.restype = ctypes.c_longlong
    return lib


def code_match_cuda(
    doc_codes: torch.Tensor,    # (d, C) int8/16/32, on the card
    qcodes: torch.Tensor,       # (Q, C) same dtype
    col_weights: torch.Tensor,  # (Q, C) f32
) -> torch.Tensor:
    """Launch the kernel -> (Q, d) f32 scores."""
    _build.check_code_inputs("code_match", doc_codes, qcodes, col_weights)
    dev = doc_codes.device
    d, C = doc_codes.shape
    Q = qcodes.shape[0]
    es = doc_codes.element_size()
    props = torch.cuda.get_device_properties(dev)
    lib = library()
    block_q, sub, stride = _build.launch_sizes(
        lambda bq, sb, st: lib.code_match_smem_bytes(es, bq, C, sb, st),
        Q, C, es, _build.THREADS, _build.smem_optin(props))
    n_qt = -(-Q // block_q)
    n_sub = -(-d // sub)
    splits = max(1, min(n_sub, 65535,
                        -(-_BLOCKS_PER_SM * props.multi_processor_count
                          // n_qt)))
    chunk = -(-n_sub // splits) * sub
    splits = -(-d // chunk)
    out = torch.empty((Q, d), dtype=torch.float32, device=dev)
    fn = getattr(lib, _ENTRY[doc_codes.dtype])
    with _build.launch_record("code_match"):
        err = fn(doc_codes.data_ptr(), qcodes.data_ptr(),
                 col_weights.data_ptr(), d, C, Q, block_q, sub, stride,
                 chunk, splits, out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"code_match kernel launch failed: CUDA error "
                           f"{err}")
    return out
