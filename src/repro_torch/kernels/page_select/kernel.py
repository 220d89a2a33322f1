"""Launcher of the hand-written CUDA page selection
(``csrc/page_select.cu``, which replaces no TPU kernel: the JAX package
cuts the page with ``lax.top_k``).

This module checks its inputs, sizes the launch (:func:`launch_plan`:
splits of each row that fill the card's SMs in one wave, tiles of the
page for the sort), allocates the workspace and the (Q, page) outputs
with ``torch.empty`` on the input's device, and launches the kernels on
PyTorch's current stream (nothing for a matrix of no rows).  It raises on
anything the kernels do not take (no columns, a page outside [1, d], a
dtype other than float32) and when a launch reports a CUDA error.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["page_select_cuda", "launch_plan", "KERNELS_PER_CALL", "TILE",
           "library"]

# three (histogram, scan) pairs, the write, the sort, the rank
KERNELS_PER_CALL = 9

TILE = 4096                # kTile: words a sort block orders
BINS = 2048                # kBins: a histogram's bins
STATE = 3                  # kState: ints of a query's state
_BLOCKS_PER_SM = 2         # kMinBlocks: resident 512-thread blocks an SM
_MAX_SPLITS = 128          # at most kThreads (512); few, as one block a
                           # query scans their histograms
_MIN_SPLIT = 4096          # scores; shorter splits are all launch

_SOURCES = (pathlib.Path(__file__).parent / "csrc" / "page_select.cu",
            pathlib.Path(__file__).parent / "csrc" / "select_key.cuh",
            pathlib.Path(__file__).parents[1] / "csrc" / "block_scan.cuh")
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 6
             + [ctypes.c_void_p] * 8)


def library() -> ctypes.CDLL:
    """The built kernel library (nvcc at first use, then cached)."""
    lib = _build.load_library("page_select", _SOURCES)
    lib.page_select.argtypes = _ARGTYPES
    lib.page_select.restype = ctypes.c_int
    return lib


def launch_plan(Q: int, d: int, page: int, n_sm: int) -> Tuple[int, int,
                                                                int]:
    """-> (n_splits, split_len, n_tiles): each row cut into the most
    splits of at least ``_MIN_SPLIT`` scores (a whole number of four, so a
    row that starts 16-byte aligned keeps its splits aligned) for which
    the Q * n_splits blocks all fit the card at once, at most
    ``_MAX_SPLITS``; the page cut into tiles of ``TILE`` words."""
    n = max(1, min(n_sm * _BLOCKS_PER_SM // Q, _MAX_SPLITS,
                   -(-d // _MIN_SPLIT)))
    split_len = -(-(-(-d // n)) // 4) * 4
    return -(-d // split_len), split_len, -(-page // TILE)


def _check(scores: torch.Tensor, page: int) -> None:
    if scores.device.type != "cuda":
        raise ValueError(f"page_select kernel needs a CUDA tensor, got "
                         f"{scores.device}")
    if scores.dtype != torch.float32:
        raise TypeError(f"scores must be float32, got {scores.dtype}")
    if scores.dim() != 2:
        raise ValueError(f"scores must be (Q, d), got {tuple(scores.shape)}")
    if not scores.is_contiguous():
        raise ValueError("scores must be contiguous")
    Q, d = scores.shape
    if d < 1:
        raise ValueError(f"empty input: Q={Q}, d={d}")
    if d >= 2 ** 31:
        raise ValueError(f"d={d} does not fit int32 positions")
    if not 1 <= page <= d:
        raise ValueError(f"page={page} outside [1, d={d}]")


def page_select_cuda(scores: torch.Tensor, page: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernels -> (values (Q, page) f32, positions (Q, page)
    int64), ``stable_topk(scores, page)``'s."""
    _check(scores, page)
    dev = scores.device
    Q, d = scores.shape
    values = torch.empty((Q, page), dtype=torch.float32, device=dev)
    positions = torch.empty((Q, page), dtype=torch.int64, device=dev)
    if Q == 0:                   # no rows: nothing to launch
        return values, positions
    props = torch.cuda.get_device_properties(dev)
    n_splits, split_len, n_tiles = launch_plan(
        Q, d, page, props.multi_processor_count)
    lib = library()
    blocks = Q * n_splits
    ws = torch.empty(blocks * (BINS + 2) + Q * STATE, dtype=torch.int32,
                     device=dev)
    words = torch.empty((2, Q, page), dtype=torch.int64, device=dev)
    base = ws.data_ptr()
    with _build.launch_record("page_select"):
        err = lib.page_select(
            scores.data_ptr(), Q, d, page, n_splits, split_len, n_tiles,
            base, base + 4 * blocks * BINS,
            base + 4 * (blocks * BINS + Q * STATE),
            words[0].data_ptr(), words[1].data_ptr(), values.data_ptr(),
            positions.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"page_select kernel launch failed: CUDA error "
                           f"{err}")
    return values, positions
