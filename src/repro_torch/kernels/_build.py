"""Build the hand-written CUDA kernels with ``nvcc`` and bind them with
``ctypes``; the launch arithmetic their wrappers share.

Each kernel's ``csrc/*.cu`` has a plain C interface (``extern "C"``
functions taking pointers, ints and a stream, returning a ``cudaError_t``),
so it compiles in seconds into a shared library with no PyTorch headers.
The library is built at first use, for ``sm_90a``, into
``build/repro_torch_kernels/`` at the root of the checkout (override with
``REPRO_TORCH_BUILD_DIR``), and cached under a hash of its sources and
flags.  A library's ``sources`` name every file it is built from, the
``.cuh`` headers its ``.cu`` files include as well: the hash covers them
all, so an edit to a shared header rebuilds every library that includes
it.  Libraries of different names build in parallel.  Nothing here runs
when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Callable, Dict, Sequence, Tuple

import torch

__all__ = ["NVCC_FLAGS", "build_dir", "load_library", "row_stride",
           "launch_sizes", "smem_optin", "check_code_inputs", "THREADS",
           "STAGE_BYTES", "MAX_COLUMNS"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

THREADS = 512              # kThreads of every kernel: cells scored at once
MAX_COLUMNS = 4096         # C the code-match tree takes (kMaxLogC 12)
STAGE_BYTES = 1 << 16      # most shared memory for staged doc rows
_BLOCK_Q = (8, 4, 2, 1)    # query-tile sizes, largest that fits wins
_SMEM_OPTIN = 232448       # shared memory a block may opt into on sm_90

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
_lock = threading.Lock()
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get(
        "REPRO_TORCH_BUILD_DIR", _REPO_ROOT / "build" / "repro_torch_kernels"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "CUDA kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def load_library(name: str, sources: Sequence[pathlib.Path]) -> ctypes.CDLL:
    """Build (once, cached by content) and load the shared library ``name``
    from ``sources``: the ``.cu`` files are compiled, every file is hashed.
    Raises with nvcc's output if the build fails."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources:
            h.update(pathlib.Path(src).read_bytes())
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        so = out_dir / f"{name}-{h.hexdigest()[:16]}.so"
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(s) for s in sources if str(s).endswith(".cu")]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            (out_dir / f"{name}.log").write_text(
                " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        _libs[name] = ctypes.CDLL(str(so))
        return _libs[name]


def check_code_inputs(what: str, doc_codes, qcodes, col_weights) -> None:
    """Raise on code-match inputs a kernel does not take: not on one CUDA
    device, other dtypes than int8/16/32 codes (both the same) and f32
    weights, shapes other than (d, C), (Q, C), (Q, C), non-contiguous,
    empty, more than int32 doc ids or ``MAX_COLUMNS`` columns."""
    dev = doc_codes.device
    if dev.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {dev}")
    for name, t in (("qcodes", qcodes), ("col_weights", col_weights)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, doc_codes on {dev}")
    if doc_codes.dtype not in (torch.int8, torch.int16, torch.int32):
        raise TypeError(f"doc code dtype {doc_codes.dtype} not supported "
                        f"(int8, int16, int32)")
    if qcodes.dtype != doc_codes.dtype:
        raise TypeError(f"qcodes {qcodes.dtype} != doc codes "
                        f"{doc_codes.dtype}")
    if col_weights.dtype != torch.float32:
        raise TypeError(f"col_weights must be float32, got "
                        f"{col_weights.dtype}")
    if doc_codes.dim() != 2 or qcodes.dim() != 2:
        raise ValueError("doc_codes (d, C) and qcodes (Q, C) must be 2-D")
    d, C = doc_codes.shape
    Q = qcodes.shape[0]
    if qcodes.shape[1] != C or col_weights.shape != (Q, C):
        raise ValueError(f"shape mismatch: doc_codes {tuple(doc_codes.shape)}"
                         f", qcodes {tuple(qcodes.shape)}, col_weights "
                         f"{tuple(col_weights.shape)}")
    for name, t in (("doc_codes", doc_codes), ("qcodes", qcodes),
                    ("col_weights", col_weights)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d < 1 or Q < 1 or C < 1:
        raise ValueError(f"empty input: d={d}, Q={Q}, C={C}")
    if d >= 2 ** 31:
        raise ValueError(f"d={d} does not fit int32 doc ids")
    if C > MAX_COLUMNS:
        raise ValueError(f"C={C} > {MAX_COLUMNS} code columns")


def smem_optin(props) -> int:
    """Shared memory a block may opt into on the card of ``props``."""
    return getattr(props, "shared_memory_per_block_optin", _SMEM_OPTIN)


def row_stride(width: int, itemsize: int) -> int:
    """Elements per staged doc row: at least ``width``, a whole and odd
    number of 4-byte words, so the 32 rows a warp reads at one column fall
    in 32 different shared-memory banks."""
    per_word = 4 // itemsize
    words = -(-width // per_word)
    return (words + 1 - words % 2) * per_word


def launch_sizes(smem_bytes: Callable[[int, int, int], int], Q: int,
                 width: int, itemsize: int, max_sub: int,
                 smem_max: int) -> Tuple[int, int, int]:
    """-> (block_q, sub, stride): the largest query tile (at most Q, from
    8 down to 1) whose shared memory ``smem_bytes(block_q, sub, stride)``
    fits ``smem_max``, with ``sub`` staged rows (a power of two, about one
    cell per thread, at most ``max_sub``, within the staging budget).
    Raises ValueError when even a query tile of one does not fit."""
    stride = row_stride(width, itemsize)
    need = None
    for block_q in _BLOCK_Q:
        block_q = min(block_q, Q)
        sub = min(1 << ((THREADS // block_q).bit_length() - 1), max_sub)
        while sub > 1 and sub * stride * itemsize > STAGE_BYTES:
            sub //= 2
        need = smem_bytes(block_q, sub, stride)
        if 0 < need <= smem_max:
            return block_q, sub, stride
    raise ValueError(f"{need} B of shared memory needed, more than the "
                     f"card's {smem_max}")
