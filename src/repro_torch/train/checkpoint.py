"""Atomic, async checkpointing in the JAX package's layout.

Layout:  <dir>/step_<N>/
            manifest.json          -- leaf count, shapes and logical dtypes
            shard<P>_leaf<i>.npy   -- leaf payloads, leaf i in JAX's flatten
                                      order of the tree (``train.tree``)
A checkpoint is *complete* only once ``manifest.json`` exists: it is
written last, into a temporary directory that is then renamed into place,
so a crash mid-write is never taken for a checkpoint and restore picks
the newest complete step.  npy has no bf16: such a leaf is stored widened
to f32, its logical dtype recorded, and cast back on restore.  The JAX
package's ``restore_checkpoint`` reads these directories and this one
reads the JAX package's (the manifest's ``treedef`` text is informative;
neither side parses it).  ``AsyncCheckpointer`` copies the tree to the
host, then writes on a background thread.  One process: P = 0.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .tree import tree_leaves, tree_map

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer"]

PROC = 0


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """-> (the array npy stores, the leaf's logical dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        logical = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy(), logical
    arr = np.asarray(leaf)
    logical = str(arr.dtype)
    if arr.dtype.kind == "V" or logical == "bfloat16":
        arr = arr.astype(np.float32)
    return arr, logical


def _describe(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (f"{type(tree).__name__}("
                + ", ".join(f"{f}={_describe(v)}" for f, v in zip(tree._fields, tree))
                + ")")
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_describe(v) for v in tree) + "]"
    return "None" if tree is None else "*"


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Write ``tree`` (tensors on any device, or numpy arrays) as step
    ``step`` -> the step's directory."""
    leaves = tree_leaves(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp{PROC}"
    os.makedirs(tmp, exist_ok=True)
    meta = {"treedef": _describe(tree), "n_leaves": len(leaves), "step": step,
            "leaves": []}
    for i, leaf in enumerate(leaves):
        arr, logical = _to_host(leaf)
        np.save(os.path.join(tmp, f"shard{PROC}_leaf{i}.npy"), arr)
        meta["leaves"].append({"i": i, "shape": list(arr.shape),
                               "dtype": logical})
    # manifest last; the directory rename is atomic on POSIX
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(meta, f)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _complete_steps(ckpt_dir: str) -> list:
    return [int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
            if name.startswith("step_") and "." not in name
            and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json"))]


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _complete_steps(ckpt_dir)
    return max(steps) if steps else None


def _like(arr: np.ndarray, ref):
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype)
    return np.asarray(arr, dtype=np.asarray(ref).dtype)


def restore_checkpoint(ckpt_dir: str, tree_like: Any, step: Optional[int] = None
                       ) -> Tuple[Any, Optional[int]]:
    """Restore into the structure, devices and dtypes of ``tree_like``;
    -> (tree, step|None)."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return tree_like, None
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        n = json.load(f)["n_leaves"]
    n_like = len(tree_leaves(tree_like))
    if n != n_like:
        raise ValueError(f"{path} holds {n} leaves, the tree {n_like}")
    i = iter(range(n))
    out = tree_map(lambda ref: _like(
        np.load(os.path.join(path, f"shard{PROC}_leaf{next(i)}.npy")), ref),
        tree_like)
    return out, step


class AsyncCheckpointer:
    """Background-thread checkpoint writer with double buffering."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any):
        self.wait()
        # snapshot before the async write (the caller may update in place)
        host_tree = tree_map(
            lambda l: (l.detach().to("cpu", copy=True)
                       if isinstance(l, torch.Tensor) else np.array(l)), tree)

        def _run():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in sorted(_complete_steps(self.ckpt_dir))[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
