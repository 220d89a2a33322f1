"""Launcher of the hand-written CUDA rerank kernels
(``csrc/rerank_topk.cu``, which replaces the TPU kernel
``src/repro/kernels/rerank_topk/kernel.py::rerank_scores_pallas``).

The kernels gather the candidate rows themselves: they take the (d, n)
table, the (Q, P) int32 ids and the (Q, n) queries.  They allocate
nothing: this module checks the inputs, makes the launch plan, allocates
the (Q, P) scores with ``torch.empty`` on the input's device, and
launches on PyTorch's current stream.  It raises on anything the kernels
do not take, and when the launch reports a CUDA error.

The plan (:func:`launch_plan`) picks one of two bodies by shape and
alignment: ``"bulk"`` (rows copied by ``cp.async.bulk`` into a ring of
stages walked by persistent blocks) where n % 4 == 0, the table and the
queries are 16-byte aligned and the ring fits shared memory, else
``"simple"`` (a block per 32 candidates of one query).  The plan's
arithmetic -- rows a stage, stages, blocks, shared memory -- lives here,
where the CPU tests reach it; :func:`work_items` lists the (q, rows) each
bulk block scores, in the kernel's order.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["rerank_scores_cuda", "launch", "launch_plan", "plan_for",
           "work_items", "bulk_smem_bytes", "Plan", "BODIES",
           "KERNELS_PER_CALL", "library"]

KERNELS_PER_CALL = 1       # rerank_bulk_kernel or rerank_scores_kernel
BODIES = ("bulk", "simple")

CONSUMER_WARPS = 4         # kConsumerWarps (and one producer warp)
SIMPLE_CANDIDATES = 32     # kCandPerBlock: candidates a simple block
MAX_ROWS = 32              # kMaxRows: rows a stage, one id a producer lane
STAGE_BYTES = 40 * 1024    # rows a stage: as many as fit this, to MAX_ROWS
STAGES = 2                 # stages of the ring (and query slots)
BLOCKS_PER_SM = 2          # at most
BAR_BYTES = 32             # kBarBytes: four mbarriers a stage
_SMEM_PER_SM = 233472      # shared memory of an H100 SM (228 KB)
_SMEM_RESERVED = 1024      # what the runtime keeps of it for each block

_SOURCES = (pathlib.Path(__file__).parent / "csrc" / "rerank_topk.cu",)

_lib: Optional[ctypes.CDLL] = None
_limits: Dict[int, Tuple[int, int, int]] = {}
# (device, body) -> the dynamic shared memory limit set for it so far
_smem_set: Dict[Tuple[int, str], int] = {}


@dataclass(frozen=True)
class Plan:
    """One launch: the body, its grid and dynamic shared memory; for the
    bulk body the rows a stage and the stages of its ring (as many query
    slots as stages)."""
    body: str
    blocks: int
    smem: int
    rows: int = 0
    stages: int = 0


def library() -> ctypes.CDLL:
    """The built kernel library (nvcc at first use, then cached), its
    functions' types bound once."""
    global _lib
    if _lib is None:
        lib = _build.load_library("rerank_topk", _SOURCES)
        lib.rerank_scores.argtypes = ([ctypes.c_void_p] * 3
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_void_p] * 2)
        lib.rerank_scores_bulk.argtypes = ([ctypes.c_void_p] * 3
                                           + [ctypes.c_int] * 8
                                           + [ctypes.c_void_p] * 2)
        lib.rerank_configure.argtypes = [ctypes.c_int, ctypes.c_int]
        for fn in (lib.rerank_scores, lib.rerank_scores_bulk,
                   lib.rerank_configure):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def bulk_smem_bytes(n: int, rows: int, stages: int) -> int:
    """The bulk body's shared memory: four mbarriers, a query slot and
    ``rows`` rows of n floats a stage."""
    return stages * (BAR_BYTES + (rows + 1) * 4 * n)


def _bulk_ring(n: int, smem_max: int, smem_per_sm: int
               ) -> Optional[Tuple[int, int]]:
    """-> (rows a stage, blocks an SM) of the bulk body's ring of STAGES
    stages: rows to about STAGE_BYTES a stage, a whole number a consumer
    warp where there are more rows than warps, and as many blocks an SM,
    to BLOCKS_PER_SM, as the SM's shared memory holds; None if one block
    does not fit."""
    rows = max(1, min(MAX_ROWS, STAGE_BYTES // (4 * n)))
    if rows > CONSUMER_WARPS:
        rows -= rows % CONSUMER_WARPS
    smem = bulk_smem_bytes(n, rows, STAGES)
    if smem > smem_max:
        return None
    return rows, max(1, min(BLOCKS_PER_SM,
                            smem_per_sm // (smem + _SMEM_RESERVED)))


@functools.lru_cache(maxsize=1024)
def launch_plan(Q: int, P: int, n: int, aligned: bool, smem_max: int,
                sms: int, smem_per_sm: int = _SMEM_PER_SM,
                body: Optional[str] = None) -> Plan:
    """The launch of (Q, P) candidates of n floats on a card with
    ``sms`` SMs, ``smem_max`` bytes of shared memory a block may opt into
    and ``smem_per_sm`` an SM.  ``aligned``: the table and the queries
    start on 16 bytes.  The bulk body where it can run (n % 4 == 0,
    aligned, its ring fits), else the simple one; ``body`` forces one and
    raises if it cannot run.  Raises past the largest n any body fits."""
    if body not in (None, *BODIES):
        raise ValueError(f"body must be one of {BODIES}, got {body!r}")
    ring = _bulk_ring(n, smem_max, smem_per_sm) \
        if n % 4 == 0 and aligned else None
    if body == "bulk" and ring is None:
        raise ValueError(f"the bulk body needs n % 4 == 0, a 16-byte "
                         f"aligned table and queries and a ring that fits "
                         f"{smem_max} B: n={n}, aligned={aligned}")
    if ring is not None and body != "simple":
        rows, per_sm = ring
        items = Q * -(-P // rows)
        return Plan("bulk", min(per_sm * sms, items),
                    bulk_smem_bytes(n, rows, STAGES), rows, STAGES)
    if 4 * n > smem_max:
        raise ValueError(f"a query row of n={n} floats does not fit the "
                         f"card's {smem_max} B of shared memory (the "
                         f"largest n is {smem_max // 4})")
    return Plan("simple", Q * -(-P // SIMPLE_CANDIDATES), 4 * n)


def work_items(plan: Plan, Q: int, P: int
               ) -> Iterator[Tuple[int, int, int, int]]:
    """The bulk body's work, in the kernel's order: (block, q, first
    candidate, rows) of each item a block scores, block b taking items
    b, b + blocks, ... of the query-major list of (q, tile of
    ``plan.rows`` candidates)."""
    tiles = -(-P // plan.rows)
    for b in range(plan.blocks):
        for item in range(b, Q * tiles, plan.blocks):
            q, t = divmod(item, tiles)
            p0 = t * plan.rows
            yield b, q, p0, min(plan.rows, P - p0)


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


def _device_limits(dev: torch.device) -> Tuple[int, int, int]:
    """(opt-in shared memory a block, SMs, shared memory an SM) of the
    card, read once per device."""
    lim = _limits.get(dev.index)
    if lim is None:
        props = torch.cuda.get_device_properties(dev)
        lim = _limits[dev.index] = (
            _build.smem_optin(props), props.multi_processor_count,
            getattr(props, "shared_memory_per_multiprocessor", _SMEM_PER_SM))
    return lim


def plan_for(table: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor,
             body: Optional[str] = None) -> Plan:
    """The plan :func:`launch` follows for these (checked) inputs."""
    aligned = table.data_ptr() % 16 == 0 and queries.data_ptr() % 16 == 0
    return launch_plan(ids.shape[0], ids.shape[1], table.shape[1], aligned,
                       *_device_limits(table.device), body=body)


def launch(table: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor,
           body: Optional[str] = None) -> Tuple[torch.Tensor, Plan]:
    """Check, plan and launch one kernel -> ((Q, P) f32 scores of the rows
    ``table[ids]`` against their queries, ids clamped to [0, d); the plan
    it ran).  ``body`` forces a body (for tests and timings)."""
    _check(table, ids, queries)
    dev = table.device
    plan = plan_for(table, ids, queries, body)
    lib = library()
    key = (dev.index, plan.body)
    if plan.smem > _smem_set.get(key, 0):   # a limit, so only ever raised
        with torch.cuda.device(dev):
            err = lib.rerank_configure(BODIES.index(plan.body), plan.smem)
        if err != 0:
            raise RuntimeError(f"rerank kernel: setting {plan.smem} B of "
                               f"shared memory failed: CUDA error {err}")
        _smem_set[key] = plan.smem
    d, n = table.shape
    Q, P = ids.shape
    out = torch.empty((Q, P), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _build.launch_record("rerank_topk"):
        if plan.body == "bulk":
            err = lib.rerank_scores_bulk(
                table.data_ptr(), ids.data_ptr(), queries.data_ptr(), d, Q,
                P, n, plan.rows, plan.stages, plan.blocks, plan.smem,
                out.data_ptr(), stream)
        else:
            err = lib.rerank_scores(table.data_ptr(), ids.data_ptr(),
                                    queries.data_ptr(), d, Q, P, n,
                                    out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rerank kernel launch failed: CUDA error {err}")
    return out, plan


def rerank_scores_cuda(table: torch.Tensor, ids: torch.Tensor,
                       queries: torch.Tensor,
                       body: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel -> (Q, P) f32 scores of the rows ``table[ids]``
    against their queries (ids clamped to [0, d)).  ``body`` is private:
    tests and ``chip_smoke.py`` force ``"bulk"`` or ``"simple"`` with it;
    the public wrappers never pass it."""
    return launch(table, ids, queries, body)[0]
