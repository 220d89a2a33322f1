"""Launcher of the hand-written CUDA posting walk
(``csrc/postings_walk.cu``, which replaces no TPU kernel: the JAX
package's walk is a plain ``segment_sum``).

This module checks its inputs, sizes the doc tile against the card's
shared memory (two blocks an SM, so the tiles are wide and few; a table
narrower than that is one tile a query), allocates the cut workspace and
the (Q, d) output with ``torch.empty`` on the input's device, and
launches both kernels on PyTorch's current stream.  It raises on anything
the kernels do not take (an empty table or batch among them), and when a
launch reports a CUDA error.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build

__all__ = ["postings_walk_cuda", "tile_width", "KERNELS_PER_CALL",
           "library"]

KERNELS_PER_CALL = 2       # postings_cut_kernel, postings_walk_kernel

_BLOCKS_PER_SM = 2         # walk blocks the tile is sized to fit an SM: at
                           # the postings cell's shapes 1 and 3 were slower
_BLOCK_RESERVED = 1024     # shared memory the runtime keeps per block
_SMEM_PER_SM = 233472      # an sm_90 SM's shared memory
_TILE_ALIGN = 32           # docs; a tile is a whole number of these
_CUT_BLOCKS_PER_SM = 16    # grid of the cut kernel (a grid-stride loop)

_SOURCES = (pathlib.Path(__file__).parent / "csrc" / "postings_walk.cu",
            pathlib.Path(__file__).parent / "csrc" / "walk_cut.cuh",
            pathlib.Path(__file__).parents[1] / "csrc" / "block_scan.cuh")
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)


def library() -> ctypes.CDLL:
    """The built kernel library (nvcc at first use, then cached)."""
    lib = _build.load_library("postings_walk", _SOURCES)
    lib.postings_walk.argtypes = _ARGTYPES
    lib.postings_walk.restype = ctypes.c_int
    lib.postings_walk_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.postings_walk_smem_bytes.restype = ctypes.c_longlong
    return lib


def tile_width(d: int, C: int, smem_per_sm: int, smem_optin: int,
               smem_bytes):
    """-> (tile, n_tiles): the widest tile, a multiple of ``_TILE_ALIGN``
    docs, whose block (``smem_bytes(tile, C)``) fits ``_BLOCKS_PER_SM``
    times into ``smem_per_sm`` and once into ``smem_optin``; then the
    fewest tiles of that width that cover ``d``, evened out so the last
    is not a sliver.  Raises ValueError when C leaves no room for a
    tile."""
    budget = min(smem_optin, smem_per_sm // _BLOCKS_PER_SM - _BLOCK_RESERVED)
    room = budget - smem_bytes(0, C)
    t_max = room // 4 // _TILE_ALIGN * _TILE_ALIGN
    if t_max < _TILE_ALIGN:
        raise ValueError(f"C={C} leaves no shared memory for a doc tile "
                         f"({budget} B a block)")
    n_tiles = -(-d // t_max)
    per = -(-d // n_tiles)
    return -(-per // _TILE_ALIGN) * _TILE_ALIGN, n_tiles


def _check(post_docs, lo, hi, weights) -> None:
    dev = post_docs.device
    if dev.type != "cuda":
        raise ValueError(f"postings_walk kernel needs CUDA tensors, got {dev}")
    for name, t in (("lo", lo), ("hi", hi), ("weights", weights)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, post_docs on {dev}")
    if post_docs.dtype != torch.int32:
        raise TypeError(f"post_docs must be int32, got {post_docs.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    if post_docs.dim() != 2 or lo.dim() != 2:
        raise ValueError("post_docs (C, d) and lo, hi, weights (Q, C) must "
                         "be 2-D")
    C, d = post_docs.shape
    Q = lo.shape[0]
    if lo.shape[1] != C or hi.shape != lo.shape or weights.shape != lo.shape:
        raise ValueError(f"shape mismatch: post_docs {tuple(post_docs.shape)}"
                         f", lo {tuple(lo.shape)}, hi {tuple(hi.shape)}, "
                         f"weights {tuple(weights.shape)}")
    if post_docs.stride(1) != 1:
        raise ValueError("post_docs rows must be contiguous")
    if C < 1 or d < 1 or Q < 1:
        raise ValueError(f"empty input: d={d}, Q={Q}, C={C}")
    if d >= 2 ** 31:
        raise ValueError(f"d={d} does not fit int32 doc ids")


def postings_walk_cuda(
    post_docs: torch.Tensor,    # (C, d) int32, each token's range ascending
    lo: torch.Tensor,           # (Q, C) range starts, any integer dtype
    hi: torch.Tensor,           # (Q, C) range ends, <= lo where not walked
    weights: torch.Tensor,      # (Q, C) f32
) -> torch.Tensor:
    """Launch both kernels -> (Q, d) f32 scores."""
    _check(post_docs, lo, hi, weights)
    dev = post_docs.device
    C, d = post_docs.shape
    Q = lo.shape[0]
    props = torch.cuda.get_device_properties(dev)
    lib = library()
    tile, n_tiles = tile_width(
        d, C, getattr(props, "shared_memory_per_multiprocessor",
                      _SMEM_PER_SM),
        _build.smem_optin(props), lib.postings_walk_smem_bytes)
    lo32 = lo.to(torch.int32).contiguous()
    hi32 = hi.to(torch.int32).contiguous()
    w = weights.contiguous()
    stride = post_docs.stride(0) if C > 1 else d
    cuts = torch.empty((Q, n_tiles + 1, C), dtype=torch.int32, device=dev)
    out = torch.empty((Q, d), dtype=torch.float32, device=dev)
    cut_blocks = max(1, min(_CUT_BLOCKS_PER_SM * props.multi_processor_count,
                            -(-cuts.numel() // 512)))
    with _build.launch_record("postings_walk"):
        err = lib.postings_walk(
            post_docs.data_ptr(), stride, lo32.data_ptr(),
            hi32.data_ptr(), w.data_ptr(), d, C, Q, tile, n_tiles,
            cut_blocks, cuts.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"postings_walk kernel launch failed: CUDA error "
                           f"{err}")
    return out
