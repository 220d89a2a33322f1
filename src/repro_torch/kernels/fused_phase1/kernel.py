"""Launcher of the hand-written CUDA fused phase-1 kernel
(``csrc/fused_phase1.cu``, which replaces the TPU kernel
``src/repro/kernels/fused_phase1/kernel.py::fused_phase1_pallas``).

The kernel allocates nothing: this module checks its inputs, sizes the
launch (query tile, doc tile, doc splits) against the card, allocates the
partial and final outputs with ``torch.empty`` on the input's device, and
launches on PyTorch's current stream.  It raises on anything the kernel
does not take, and when the launch reports a CUDA error.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["fused_phase1_cuda", "KERNELS_PER_CALL", "MAX_PAGE", "MAX_COLUMNS",
           "library"]

KERNELS_PER_CALL = 2       # score_fold_kernel, then merge_splits_kernel

MAX_PAGE = 1024            # next_pow2(page) slots per query in shared memory
MAX_COLUMNS = 4096         # depth of the per-cell tree stack
_MIN_TILE = 512            # docs sorted per tile (at least next_pow2(page))
_BLOCK_Q = (8, 4, 2, 1)    # query-tile sizes, largest that fits wins
_THREADS = 512             # kThreads of the kernel: cells scored at once
_STAGE_BYTES = 1 << 16     # most shared memory for staged code rows
_SMEM_OPTIN = 232448       # shared memory a block may opt into on sm_90
_BLOCKS_PER_SM = 2         # doc splits aim at this many blocks per SM

_SOURCES = (pathlib.Path(__file__).parent / "csrc" / "fused_phase1.cu",)
_ENTRY = {torch.int8: "fused_phase1_int8", torch.int16: "fused_phase1_int16",
          torch.int32: "fused_phase1_int32"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
             + [ctypes.c_void_p] * 5)


def library() -> ctypes.CDLL:
    """The built kernel library (nvcc at first use, then cached)."""
    lib = _build.load_library("fused_phase1", _SOURCES)
    for fn in _ENTRY.values():
        getattr(lib, fn).argtypes = _ARGTYPES
        getattr(lib, fn).restype = ctypes.c_int
    lib.fused_phase1_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.fused_phase1_smem_bytes.restype = ctypes.c_longlong
    return lib


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def _row_stride(C: int, itemsize: int) -> int:
    """Elements per staged code row: at least C, a whole and odd number of
    4-byte words, so the 32 rows a warp reads at one column fall in 32
    different shared-memory banks."""
    per_word = 4 // itemsize
    words = -(-C // per_word)
    return (words + 1 - words % 2) * per_word


def _launch_sizes(lib, itemsize, Q, C, page, tile, smem_max):
    """-> (block_q, sub, stride): the largest query tile (at most Q) whose
    shared memory fits, with ``sub`` staged rows (about one cell per
    thread where the staging budget allows)."""
    stride = _row_stride(C, itemsize)
    need = None
    for block_q in _BLOCK_Q:
        block_q = min(block_q, Q)
        sub = min(1 << ((_THREADS // block_q).bit_length() - 1), tile)
        while sub > 1 and sub * stride * itemsize > _STAGE_BYTES:
            sub //= 2
        need = lib.fused_phase1_smem_bytes(itemsize, block_q, page, tile, C,
                                           sub, stride)
        if need <= smem_max:
            return block_q, sub, stride
    raise ValueError(f"C={C}, page={page} need {need} B of shared memory, "
                     f"more than the card's {smem_max}")


def _check(doc_codes, qcodes, col_weights, page, live):
    dev = doc_codes.device
    if dev.type != "cuda":
        raise ValueError(f"fused_phase1 kernel needs CUDA tensors, got {dev}")
    for name, t in (("qcodes", qcodes), ("col_weights", col_weights),
                    ("live", live)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, doc_codes on {dev}")
    if doc_codes.dtype not in _ENTRY:
        raise TypeError(f"doc code dtype {doc_codes.dtype} not supported "
                        f"(int8, int16, int32)")
    if qcodes.dtype != doc_codes.dtype:
        raise TypeError(f"qcodes {qcodes.dtype} != doc codes "
                        f"{doc_codes.dtype}")
    if col_weights.dtype != torch.float32:
        raise TypeError(f"col_weights must be float32, got "
                        f"{col_weights.dtype}")
    if live is not None and (live.dtype != torch.bool
                             or live.shape != (doc_codes.shape[0],)):
        raise ValueError(f"live must be bool of shape "
                         f"({doc_codes.shape[0]},)")
    if doc_codes.dim() != 2 or qcodes.dim() != 2:
        raise ValueError("doc_codes (d, C) and qcodes (Q, C) must be 2-D")
    d, C = doc_codes.shape
    Q = qcodes.shape[0]
    if qcodes.shape[1] != C or col_weights.shape != (Q, C):
        raise ValueError(f"shape mismatch: doc_codes {tuple(doc_codes.shape)}"
                         f", qcodes {tuple(qcodes.shape)}, col_weights "
                         f"{tuple(col_weights.shape)}")
    for name, t in (("doc_codes", doc_codes), ("qcodes", qcodes),
                    ("col_weights", col_weights), ("live", live)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d < 1 or Q < 1 or C < 1:
        raise ValueError(f"empty input: d={d}, Q={Q}, C={C}")
    if d >= 2 ** 31:
        raise ValueError(f"d={d} does not fit int32 doc ids")
    if C > MAX_COLUMNS:
        raise ValueError(f"C={C} > {MAX_COLUMNS} code columns")
    if not 1 <= page <= min(MAX_PAGE, d):
        raise ValueError(f"page={page} outside [1, min({MAX_PAGE}, d={d})]")


def fused_phase1_cuda(
    doc_codes: torch.Tensor,    # (d, C) int8/16/32, on the card
    qcodes: torch.Tensor,       # (Q, C) same dtype
    col_weights: torch.Tensor,  # (Q, C) f32
    page: int,
    live: Optional[torch.Tensor] = None,   # (d,) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel -> (scores (Q, page) f32, ids (Q, page) int32)."""
    _check(doc_codes, qcodes, col_weights, page, live)
    dev = doc_codes.device
    d, C = doc_codes.shape
    Q = qcodes.shape[0]
    pp = _next_pow2(page)
    tile = max(pp, _MIN_TILE)
    props = torch.cuda.get_device_properties(dev)
    smem_max = getattr(props, "shared_memory_per_block_optin", _SMEM_OPTIN)
    lib = library()
    block_q, sub, stride = _launch_sizes(
        lib, doc_codes.element_size(), Q, C, page, tile, smem_max)
    n_qt = -(-Q // block_q)
    n_tiles = -(-d // tile)
    splits = max(1, min(n_tiles, 65535,
                        -(-_BLOCKS_PER_SM * props.multi_processor_count
                          // n_qt)))
    chunk = -(-n_tiles // splits) * tile
    splits = -(-d // chunk)
    part_s = torch.empty((Q, splits, pp), dtype=torch.float32, device=dev)
    part_i = torch.empty((Q, splits, pp), dtype=torch.int32, device=dev)
    out_s = torch.empty((Q, page), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, page), dtype=torch.int32, device=dev)
    fn = getattr(lib, _ENTRY[doc_codes.dtype])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(doc_codes.data_ptr(), qcodes.data_ptr(), col_weights.data_ptr(),
             None if live is None else live.data_ptr(),
             d, C, Q, page, block_q, tile, sub, stride, chunk, splits,
             part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
             out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_phase1 kernel launch failed: CUDA error "
                           f"{err}")
    return out_s, out_i
