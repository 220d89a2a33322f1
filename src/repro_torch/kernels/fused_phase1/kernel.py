"""Launchers of the hand-written CUDA fused phase-1 kernels:

* ``fused_phase1_cuda`` (``csrc/fused_phase1.cu``), replacing the TPU
  kernel ``src/repro/kernels/fused_phase1/kernel.py::fused_phase1_pallas``;
* ``fused_phase1_quant_cuda`` (``csrc/fused_phase1_quant.cu``), replacing
  ``src/repro/kernels/fused_phase1/kernel.py::fused_phase1_quant_pallas``.

Both share the running top-``page`` fold of ``csrc/topk_fold.cuh``; the
int8 kernel scores on the int8 tensor cores (``mma.sync`` of ``sm_90a``,
numerics in ``csrc/quant_mma.cuh``) with its rows staged by ``cp.async``
into two buffers (:func:`_quant_plan`).  The
kernels allocate nothing: this module checks the inputs, sizes the launch
(query tile, doc tile, doc splits) against the card, allocates the partial
and final outputs with ``torch.empty`` on the input's device, and launches
on PyTorch's current stream.  Where a page's accumulator and tile do not
fit a block's shared memory (next_pow2(page) > 8192 on an H100), it also
allocates the fold's device-memory workspace, and cuts the doc splits so
that the workspace stays near ``WORKSPACE_BYTES``; any page that fits
device memory runs.  It raises on anything a kernel does not take, and
when a launch reports a CUDA error.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["fused_phase1_cuda", "fused_phase1_quant_cuda", "KERNELS_PER_CALL",
           "WORKSPACE_BYTES", "FoldPlan", "library", "quant_library"]

KERNELS_PER_CALL = 2       # score_fold_kernel, then merge_splits_kernel

_MIN_TILE = 512            # docs sorted per tile (at least next_pow2(page))
_BLOCKS_PER_SM = 2         # doc splits aim at this many blocks per SM
WORKSPACE_BYTES = 1 << 28  # the fold's device workspace, when it spills,
                           # is cut to about this by fewer doc splits
_MMA_ROWS = 16             # doc rows of one int8 tensor-core tile

_CSRC = pathlib.Path(__file__).parent / "csrc"
_SHARED = (_CSRC / "topk_fold.cuh",
           pathlib.Path(__file__).parents[1] / "csrc" / "match_tree.cuh")
_SOURCES = (_CSRC / "fused_phase1.cu", *_SHARED)
_QUANT_SOURCES = (_CSRC / "fused_phase1_quant.cu", _CSRC / "quant_mma.cuh",
                  *_SHARED)
_ENTRY = {torch.int8: "fused_phase1_int8", torch.int16: "fused_phase1_int16",
          torch.int32: "fused_phase1_int32"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
             + [ctypes.c_void_p] * 7)
_QUANT_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p] * 7)


def library() -> ctypes.CDLL:
    """The built fp32 kernel library (nvcc at first use, then cached)."""
    lib = _build.load_library("fused_phase1", _SOURCES)
    for fn in _ENTRY.values():
        getattr(lib, fn).argtypes = _ARGTYPES
        getattr(lib, fn).restype = ctypes.c_int
    lib.fused_phase1_smem_bytes.argtypes = [ctypes.c_int] * 8
    lib.fused_phase1_smem_bytes.restype = ctypes.c_longlong
    return lib


def quant_library() -> ctypes.CDLL:
    """The built int8 kernel library (nvcc at first use, then cached)."""
    lib = _build.load_library("fused_phase1_quant", _QUANT_SOURCES)
    lib.fused_phase1_quant.argtypes = _QUANT_ARGTYPES
    lib.fused_phase1_quant.restype = ctypes.c_int
    lib.fused_phase1_quant_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.fused_phase1_quant_smem_bytes.restype = ctypes.c_longlong
    return lib


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


class FoldPlan(NamedTuple):
    """Launch sizes of one fold.  ``spill``: the accumulator and tile live
    in the device workspace; ``merge_spill``: so does pass 2's
    accumulator."""

    block_q: int
    sub: int
    stride: int
    tile: int
    chunk: int
    splits: int
    spill: bool
    merge_spill: bool


def _fold_plan(smem: Callable, d: int, Q: int, width: int, itemsize: int,
               page: int, props, **staging) -> FoldPlan:
    """Size one fold; ``smem(block_q, page, tile, sub, stride, spill)`` is
    pass 1's shared memory in bytes, and ``staging`` (``stride``,
    ``sub_start``, ``min_sub``) goes to :func:`_build.launch_sizes`.  The
    accumulator and tile go to shared memory where some query tile fits,
    else to the workspace, with the doc splits cut so that it stays near
    ``WORKSPACE_BYTES`` (one split at least).  Raises ValueError only when
    the queries and staged rows alone do not fit shared memory."""
    smem_max = _build.smem_optin(props)
    pp = _next_pow2(page)
    tile = max(pp, _MIN_TILE)
    spill = False
    try:
        block_q, sub, stride = _build.launch_sizes(
            lambda bq, sb, st: smem(bq, page, tile, sb, st, 0),
            Q, width, itemsize, tile, smem_max, **staging)
    except ValueError:
        spill = True
        block_q, sub, stride = _build.launch_sizes(
            lambda bq, sb, st: smem(bq, page, tile, sb, st, 1),
            Q, width, itemsize, tile, smem_max, **staging)
    n_qt = -(-Q // block_q)
    n_tiles = -(-d // tile)
    splits = max(1, min(n_tiles, 65535,
                        -(-_BLOCKS_PER_SM * props.multi_processor_count
                          // n_qt)))
    if spill:
        per_split = n_qt * _fold_ws_bytes(block_q, pp, tile)
        splits = max(1, min(splits, WORKSPACE_BYTES // per_split))
    chunk = -(-n_tiles // splits) * tile
    splits = -(-d // chunk)
    return FoldPlan(block_q, sub, stride, tile, chunk, splits, spill,
                    8 * pp > smem_max)


def _quant_plan(smem: Callable, d: int, Q: int, n: int, page: int,
                props) -> FoldPlan:
    """The int8 kernel's fold plan: rows at :func:`_build.mma_row_stride`,
    and sub-blocks of whole 16-row tensor-core tiles, one a warp at most
    (the two staging buffers are in ``smem``)."""
    return _fold_plan(smem, d, Q, n, 1, page, props,
                      stride=_build.mma_row_stride(n),
                      sub_start=_MMA_ROWS * _build.THREADS // 32,
                      min_sub=_MMA_ROWS)


def _fold_ws_bytes(block_q: int, pp: int, tile: int) -> int:
    """One pass-1 block's workspace: its accumulator and tile, 8 bytes a
    slot (topk_fold.cuh's fold_ws_words)."""
    return 8 * block_q * (pp + tile)


def _same_device(dev, **tensors):
    for name, t in tensors.items():
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")


def _contiguous(**tensors):
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_live(live, d):
    if live is not None and (live.dtype != torch.bool
                             or live.shape != (d,)):
        raise ValueError(f"live must be bool of shape ({d},)")


def _check_page(page, d):
    if d < 1:
        raise ValueError(f"empty doc table: d={d}")
    if d >= 2 ** 31:
        raise ValueError(f"d={d} does not fit int32 doc ids")
    if not 1 <= page <= d:
        raise ValueError(f"page={page} outside [1, d={d}]")


def _check(doc_codes, qcodes, col_weights, page, live):
    _build.check_code_inputs("fused_phase1", doc_codes, qcodes, col_weights)
    _same_device(doc_codes.device, live=live)
    _check_live(live, doc_codes.shape[0])
    _contiguous(live=live)
    _check_page(page, doc_codes.shape[0])


def _outputs(dev, Q, page, plan: FoldPlan):
    """-> (part_s, part_i, out_s, out_i, fold_ws, merge_ws): the partial
    and final outputs, and the workspaces (None on the shared routes)."""
    pp = _next_pow2(page)
    n_blocks = -(-Q // plan.block_q) * plan.splits

    def ws(nbytes):
        return torch.empty((nbytes // 4,), dtype=torch.int32, device=dev)

    return (torch.empty((Q, plan.splits, pp), dtype=torch.float32,
                        device=dev),
            torch.empty((Q, plan.splits, pp), dtype=torch.int32, device=dev),
            torch.empty((Q, page), dtype=torch.float32, device=dev),
            torch.empty((Q, page), dtype=torch.int32, device=dev),
            ws(n_blocks * _fold_ws_bytes(plan.block_q, pp, plan.tile))
            if plan.spill else None,
            ws(8 * Q * pp) if plan.merge_spill else None)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def fused_phase1_cuda(
    doc_codes: torch.Tensor,    # (d, C) int8/16/32, on the card
    qcodes: torch.Tensor,       # (Q, C) same dtype
    col_weights: torch.Tensor,  # (Q, C) f32
    page: int,
    live: Optional[torch.Tensor] = None,   # (d,) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fp32 kernel -> (scores (Q, page) f32, ids (Q, page)
    int32)."""
    _check(doc_codes, qcodes, col_weights, page, live)
    dev = doc_codes.device
    d, C = doc_codes.shape
    Q = qcodes.shape[0]
    es = doc_codes.element_size()
    lib = library()
    plan = _fold_plan(
        lambda bq, p, t, sb, st, sp: lib.fused_phase1_smem_bytes(
            es, bq, p, t, C, sb, st, sp),
        d, Q, C, es, page, torch.cuda.get_device_properties(dev))
    part_s, part_i, out_s, out_i, fold_ws, merge_ws = _outputs(dev, Q, page,
                                                               plan)
    fn = getattr(lib, _ENTRY[doc_codes.dtype])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _build.launch_record("fused_phase1"):
        err = fn(doc_codes.data_ptr(), qcodes.data_ptr(),
                 col_weights.data_ptr(), _ptr(live),
                 d, C, Q, page, plan.block_q, plan.tile, plan.sub,
                 plan.stride, plan.chunk, plan.splits,
                 part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
                 out_i.data_ptr(), _ptr(fold_ws), _ptr(merge_ws), stream)
    _raise_on(err, "fused_phase1")
    return out_s, out_i


def _check_quant(codes8, scale, zero, queries, page, live):
    dev = codes8.device
    if dev.type != "cuda":
        raise ValueError(f"fused_phase1_quant kernel needs CUDA tensors, "
                         f"got {dev}")
    _same_device(dev, scale=scale, zero=zero, queries=queries, live=live)
    if codes8.dtype != torch.int8:
        raise TypeError(f"codes8 must be int8, got {codes8.dtype}")
    for name, t in (("scale", scale), ("zero", zero), ("queries", queries)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if codes8.dim() != 2 or queries.dim() != 2:
        raise ValueError("codes8 (d, n) and queries (Q, n) must be 2-D")
    d, n = codes8.shape
    Q = queries.shape[0]
    if queries.shape[1] != n or scale.shape != (d,) or zero.shape != (d,):
        raise ValueError(f"shape mismatch: codes8 {tuple(codes8.shape)}, "
                         f"scale {tuple(scale.shape)}, zero "
                         f"{tuple(zero.shape)}, queries "
                         f"{tuple(queries.shape)}")
    _check_live(live, d)
    _contiguous(codes8=codes8, scale=scale, zero=zero, queries=queries,
                live=live)
    if Q < 1 or n < 1:
        raise ValueError(f"empty input: Q={Q}, n={n}")
    _check_page(page, d)


def fused_phase1_quant_cuda(
    codes8: torch.Tensor,       # (d, n) int8 quantized rows, on the card
    scale: torch.Tensor,        # (d,) f32
    zero: torch.Tensor,         # (d,) f32
    queries: torch.Tensor,      # (Q, n) f32
    page: int,
    live: Optional[torch.Tensor] = None,   # (d,) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the int8 kernel -> (scores (Q, page) f32, ids (Q, page)
    int32).  The query sums are taken here, as the reference's wrapper
    takes them."""
    _check_quant(codes8, scale, zero, queries, page, live)
    dev = codes8.device
    d, n = codes8.shape
    Q = queries.shape[0]
    qsum = queries.sum(dim=-1).contiguous()
    lib = quant_library()
    plan = _quant_plan(
        lambda bq, p, t, sb, st, sp: lib.fused_phase1_quant_smem_bytes(
            bq, p, t, n, sb, st, sp),
        d, Q, n, page, torch.cuda.get_device_properties(dev))
    part_s, part_i, out_s, out_i, fold_ws, merge_ws = _outputs(dev, Q, page,
                                                               plan)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _build.launch_record("fused_phase1_quant"):
        err = lib.fused_phase1_quant(
            codes8.data_ptr(), scale.data_ptr(), zero.data_ptr(),
            queries.data_ptr(), qsum.data_ptr(), _ptr(live),
            d, n, Q, page, plan.block_q, plan.tile, plan.sub, plan.stride,
            plan.chunk, plan.splits, part_s.data_ptr(), part_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), _ptr(fold_ws),
            _ptr(merge_ws), stream)
    _raise_on(err, "fused_phase1_quant")
    return out_s, out_i
