"""Build the hand-written CUDA kernels with ``nvcc`` and bind them with
``ctypes``.

Each kernel's ``csrc/*.cu`` has a plain C interface (``extern "C"``
functions taking pointers, ints and a stream, returning a ``cudaError_t``),
so it compiles in seconds into a shared library with no PyTorch headers.
The library is built at first use, for ``sm_90a``, into
``build/repro_torch_kernels/`` at the root of the checkout (override with
``REPRO_TORCH_BUILD_DIR``), and cached under a hash of its sources and
flags.  Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Dict, Sequence

__all__ = ["NVCC_FLAGS", "build_dir", "load_library"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
_lock = threading.Lock()
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
    from ``sources``.  Raises with nvcc's output if the build fails."""
    with _lock:
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
                   *[str(s) for s in sources]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            (out_dir / f"{name}.log").write_text(
                " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        _libs[name] = ctypes.CDLL(str(so))
        return _libs[name]
