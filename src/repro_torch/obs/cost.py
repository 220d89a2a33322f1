"""Analytic cost rows: operations and memory bytes per region and kernel.

The JAX package reads XLA's static cost model (FLOPs, bytes accessed) at
the moment a program compiles and files it under the innermost active
:func:`~repro_torch.obs.compile_watch.watch_region`.  The port has no
compiler to ask: its kernels are written by hand.  So its rows are
*analytic*, one per ``(region, sig, program)`` where ``program`` is the
kernel's name: each ``kernels/*/ops.py`` wrapper calls
:func:`record_kernel` with the work of the call before it dispatches, on
the kernel path and the plain path alike, so a row reads the same work
whatever implements it.  The first call with a key writes the row; later
calls with that key bump its ``launches`` (the JAX package's rows count
``compiles``).  A row is built from shapes the host already holds and
never reads a tensor's values, so recording one adds no device
synchronisation; the cost when nothing is new is a thread-local read and
one dict lookup under a lock.

A :class:`Tape` holds a thread's rows, and the launch counts of
:func:`count_launches`, while work is recorded to be run later, as a
CUDA graph's capture records the search that each replay runs
(:mod:`repro_torch.serve.graphs`); it files them once for each run.

The work models are this module's, one function a kernel, and they are
also what ``chip_smoke.py``'s ``bound_ms`` column is computed from (the
bound is the larger of bytes over :data:`HBM_BYTES_PER_S` and operations
over the peak rate of their kind).  The composed ``codes`` phase 1 is
plain torch; its row is the byte model of
``artifacts/BENCH_kernel_scale.json``: the code table, the queries, and
a (Q, d) f32 score matrix written and read back (``2 * Q * d * 4``).
The ``postings`` walk's row, :func:`postings_work`, is the same least
bytes as the benchmark's frozen copy (``portbench/roofline/postings.py``);
its work depends on the data, so its row holds the entry count of the
first call with its key.

The contract is the JAX package's: every region the build watch counted
an ``nvcc`` build for must also own a cost row
(:func:`missing_cost_regions`).  :func:`roofline` joins the rows with
measured per-phase seconds into achieved rates, and
:func:`kernel_byte_ratio` / :func:`verify_kernel_claim` hold the fused
phase 1 to fewer bytes than the composed one, reconciled against the
committed byte-model ratio of ``BENCH_kernel_scale.json`` (its
``hbm_bytes`` only: its times and ``hw_model`` are another device's).
"""

from __future__ import annotations

import contextlib
import json
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from . import compile_watch as cw

__all__ = [
    "CostTable", "Work", "record_kernel", "kernel_call", "kernel_listener",
    "Tape", "count_launches", "missing_cost_regions",
    "roofline", "kernel_byte_ratio", "verify_kernel_claim", "bound_ms",
    "fused_phase1_work", "quant_work", "code_match_work", "codes_work",
    "postings_work", "postings_walk_work", "page_select_work",
    "bucketize_work", "rerank_work",
    "HBM_BYTES_PER_S",
    "CUDA_CORE_OPS_PER_S", "INT8_TC_OPS_PER_S", "OPS_PER_ELEMENT",
]

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 33.5e12      # 67 TFLOP/s fp32 non-tensor / 2 per FMA
INT8_TC_OPS_PER_S = 1979e12        # dense int8 tensor cores (data sheet)
OPS_PER_ELEMENT = 3                # compare, select, add per (q, doc, col)

_PEAK = {"cuda_core": CUDA_CORE_OPS_PER_S, "int8_tensor_core":
         INT8_TC_OPS_PER_S}

class Work(NamedTuple):
    """The least work of one call: ``ops`` operations of kind ``kind``
    (``cuda_core`` or ``int8_tensor_core``) and ``nbytes`` of memory
    traffic, each input read once and each output written once."""

    ops: float
    nbytes: int
    kind: str = "cuda_core"


# ------------------------------------------------------------ work models
def fused_phase1_work(d: int, Q: int, C: int, page: int, code_bytes: int,
                      live: bool) -> Work:
    """fused_phase1: the (d, C) codes, the queries' codes and weights and
    the live mask read once, the (Q, page) page written once; Q*d*C
    elements at OPS_PER_ELEMENT CUDA-core instructions each."""
    nbytes = (d * C * code_bytes + Q * C * (code_bytes + 4)
              + (d if live else 0) + Q * page * 8)
    return Work(OPS_PER_ELEMENT * Q * d * C, nbytes)


def code_match_work(d: int, Q: int, C: int, code_bytes: int) -> Work:
    """code_match: the codes and queries read once, the (Q, d) f32
    matrix written once; Q*d*C elements at OPS_PER_ELEMENT each."""
    nbytes = d * C * code_bytes + Q * C * (code_bytes + 4) + Q * d * 4
    return Work(OPS_PER_ELEMENT * Q * d * C, nbytes)


def codes_work(d: int, Q: int, C: int, code_bytes: int) -> Work:
    """The composed ``codes`` phase 1 (plain torch): the code table and
    the queries read once, the (Q, d) f32 scores written and read back
    by the page selection (``BENCH_kernel_scale.json``'s byte model)."""
    nbytes = d * C * code_bytes + Q * C * (code_bytes + 4) + 2 * Q * d * 4
    return Work(OPS_PER_ELEMENT * Q * d * C, nbytes)


def postings_work(entries: int, Q: int, d: int) -> Work:
    """The ``postings`` walk of a batch: each of the ``entries`` posting
    entries walked reads its int32 doc id and reads and writes its f32
    accumulator cell (12 bytes), and the dense (Q, d) f32 accumulator is
    filled once and read once by the page selection; one add an entry."""
    return Work(entries, entries * 12 + 2 * Q * d * 4)


def postings_walk_work(entries: int, Q: int, d: int) -> Work:
    """The postings_walk kernel's own least work: each of the ``entries``
    posting entries walked reads its int32 doc id once, and each (Q, d)
    f32 score is written once (its accumulator lives in shared memory);
    one add an entry.  Below :func:`postings_work`, which also counts an
    accumulator in device memory."""
    return Work(entries, entries * 4 + Q * d * 4)


def page_select_work(Q: int, d: int, page: int) -> Work:
    """The page selection of a (Q, d) f32 score matrix: the matrix read
    once, the page's f32 values and int64 positions written once; one
    compare a score."""
    return Work(Q * d, Q * d * 4 + Q * page * 12)


def quant_work(d: int, Q: int, n: int, page: int, live: bool) -> Work:
    """fused_phase1_quant on the int8 tensor cores: the int8 rows, scale,
    zero, live mask and queries read once, the page written once;
    2*Q*d*K*3 int8 operations (the queries as three int8 pieces, K = n
    padded to whole 32-code steps)."""
    nbytes = d * n + 8 * d + (d if live else 0) + Q * n * 4 + Q * page * 8
    return Work(2 * Q * d * (-(-n // 32) * 32) * 3, nbytes,
                "int8_tensor_core")


def bucketize_work(B: int, n: int, code_bytes: int) -> Work:
    """bucketize: each f32 element read once, its code written once; a
    few operations an element."""
    return Work(4 * B * n, B * n * (4 + code_bytes))


def rerank_work(Q: int, P: int, n: int, rows: int) -> Work:
    """rerank_scores: ``rows`` candidate rows read once (the distinct ids
    of a page where they are known; the wrapper, which reads no ids,
    counts all Q*P), the ids and queries read once, the scores written
    once; one FMA per (query, candidate, feature)."""
    return Work(Q * P * n, rows * n * 4 + Q * P * 4 + Q * n * 4 + Q * P * 4)


def bound_ms(work: Work) -> Tuple[float, str]:
    """-> (least milliseconds on an H100 SXM, ``"bytes"`` or
    ``"operations"``, whichever is larger)."""
    t_bytes = work.nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = work.ops / _PEAK[work.kind] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# --------------------------------------------------------------- the table
class CostTable:
    """Per-(region, signature, program) analytic cost rows."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: Dict[Tuple, dict] = {}

    def record(self, region: str, sig: Tuple, program: str,
               work: Work) -> None:
        key = (region, sig, program)
        with self._lock:
            row = self._rows.get(key)
            if row is not None:
                row["launches"] += 1
                return
            self._rows[key] = {
                "region": region,
                "sig": [str(s) for s in sig],
                "program": program,
                "launches": 1,
                "flops": float(work.ops),
                "bytes_accessed": float(work.nbytes),
                "op_kind": work.kind,
            }

    # ------------------------------------------------------------- queries
    def rows(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._rows.values()]

    def regions(self) -> set:
        with self._lock:
            return {region for region, _sig, _prog in self._rows}

    def stats(self) -> dict:
        """Stats-section dict: row count plus per-region rollups (program
        count, launches, summed operations and bytes) and the raw rows
        for the diagnostics bundle."""
        rows = self.rows()
        by_region: Dict[str, dict] = {}
        for r in rows:
            agg = by_region.setdefault(r["region"], {
                "programs": 0, "launches": 0, "flops": 0.0,
                "bytes_accessed": 0.0,
            })
            agg["programs"] += 1
            agg["launches"] += r["launches"]
            agg["flops"] += r["flops"]
            agg["bytes_accessed"] += r["bytes_accessed"]
        return {"n_rows": len(rows), "by_region": by_region, "rows": rows}


def record_kernel(program: str, work: Work) -> None:
    """File one call of ``program`` under the innermost region active on
    this thread (``<unattributed>`` on the process-default watch outside
    every region): the attribution rule of the build watch.  While a
    :class:`Tape` is active on the thread the row goes to the tape."""
    stack = getattr(cw._TLS, "stack", None)
    if stack:
        watch, region, sig = stack[-1]
    else:
        watch, region, sig = cw.active_watch(), cw._UNATTRIBUTED, ()
    tape = getattr(_TAPE, "tape", None)
    if tape is not None:
        tape.rows.append((watch, region, sig, program, work))
        return
    watch.costs.record(region, sig, program, work)


def count_launches(count: Callable[[int], None], n: int) -> None:
    """Add ``n`` kernel launches through ``count``, a kernel module's
    counter (the ``launches`` of ``kernels/fused_phase1/ops.py`` and
    ``kernels/code_match/ops.py``, the wrappers a search reaches), or
    hold them on this thread's :class:`Tape` while one is active."""
    tape = getattr(_TAPE, "tape", None)
    if tape is None:
        count(n)
    else:
        tape.launches.append((count, n))


# the tape active on each thread (Tape.__enter__)
_TAPE = threading.local()


class Tape:
    """The bookkeeping of the kernel calls a thread makes while the tape
    is active on it (``with tape:``): each call's cost row
    (:func:`record_kernel`) and launch count (:func:`count_launches`),
    held instead of filed.  It is for work that is recorded once and run
    later, perhaps many times, as a CUDA graph's capture records work
    that each replay runs: :meth:`replay` files everything held, once
    for each run, so a run counts as the same work issued eagerly."""

    def __init__(self):
        self.rows: List[tuple] = []       # (watch, region, sig, program, work)
        self.launches: List[tuple] = []   # (count, n)
        self._prev: Optional["Tape"] = None

    def __enter__(self) -> "Tape":
        self._prev = getattr(_TAPE, "tape", None)
        _TAPE.tape = self
        return self

    def __exit__(self, *exc) -> bool:
        _TAPE.tape = self._prev
        return False

    def replay(self) -> None:
        for watch, region, sig, program, work in self.rows:
            watch.costs.record(region, sig, program, work)
        for count, n in self.launches:
            count(n)


# listeners told of each kernel call's extent on this thread (the dry
# run's op analysis: a hand-written kernel is one op of its analytic work,
# and its plain version's torch ops inside the call are not counted apart)
_LISTENERS = threading.local()


@contextlib.contextmanager
def kernel_listener(listener):
    """Tell ``listener`` (``enter(program, work)``, ``exit()``) of every
    :func:`kernel_call` on this thread while the block runs."""
    stack = getattr(_LISTENERS, "stack", None)
    if stack is None:
        stack = _LISTENERS.stack = []
    stack.append(listener)
    try:
        yield listener
    finally:
        stack.remove(listener)


@contextlib.contextmanager
def kernel_call(program: str, work: Work):
    """One call of a kernel wrapper: :func:`record_kernel`, then the
    wrapper's body (the kernel, or its plain version) inside the block,
    its extent told to the listeners of :func:`kernel_listener`."""
    record_kernel(program, work)
    listeners = list(getattr(_LISTENERS, "stack", ()))
    for lst in listeners:
        lst.enter(program, work)
    try:
        yield
    finally:
        for lst in reversed(listeners):
            lst.exit()


# ------------------------------------------------------------- derived views
def missing_cost_regions(watch) -> List[str]:
    """Regions the watch counted an ``nvcc`` build for that own NO cost
    row; empty when every building region is accounted (a build happens
    inside the first launch, after its wrapper filed the row)."""
    built = set(watch.stats()["by_function"])
    built.discard("<unattributed>")
    return sorted(built - watch.costs.regions())


def roofline(watch, phase_seconds: Dict[str, float]) -> List[dict]:
    """Join the per-region rows with measured per-phase wall time into
    achieved-rate rows.  ``phase_seconds`` maps region -> measured seconds
    for ONE execution of that region.  Where a region holds several
    programs, the one with the most bytes is taken as its main program;
    ``programs`` reports how many there were."""
    by_region: Dict[str, List[dict]] = {}
    for r in watch.costs.rows():
        by_region.setdefault(r["region"], []).append(r)
    out = []
    for region, seconds in sorted(phase_seconds.items()):
        rows = by_region.get(region)
        if not rows or seconds <= 0:
            continue
        main = max(rows, key=lambda r: r["bytes_accessed"])
        flops, nbytes = main["flops"], main["bytes_accessed"]
        out.append({
            "region": region,
            "program": main["program"],
            "programs": len(rows),
            "measured_s": float(seconds),
            "flops": flops,
            "bytes_accessed": nbytes,
            "achieved_gflops": flops / seconds / 1e9,
            "achieved_gbps": nbytes / seconds / 1e9,
            "bytes_per_flop": nbytes / flops if flops else None,
        })
    return out


def _phase1_rows_by_variant(watch, region: str = "search.query_phase"):
    from repro_torch.core.search import ENGINES

    # engine names in the query phase's sig: the page kernels', and the
    # reference's composed three (codes_pallas left out, as it leaves it)
    page = {n for n, e in ENGINES.items() if e.returns_page}
    composed_names = set(ENGINES) - page - {"codes_pallas"}
    fused: List[dict] = []
    composed: List[dict] = []
    for r in watch.costs.rows():
        if r["region"] != region or not r["bytes_accessed"]:
            continue
        sig = r["sig"]
        if any(e in sig for e in page):
            fused.append(r)
        elif any(e in sig for e in composed_names):
            composed.append(r)
    return fused, composed


def kernel_byte_ratio(watch) -> Optional[dict]:
    """Fused-vs-composed byte ratio of the phase-1 rows the serving index
    recorded under ``search.query_phase``: the most bytes among fused
    rows over the most among composed rows (the largest shapes reached).
    None until both variants have run there."""
    fused, composed = _phase1_rows_by_variant(watch)
    if not fused or not composed:
        return None
    fb = max(r["bytes_accessed"] for r in fused)
    cb = max(r["bytes_accessed"] for r in composed)
    return {
        "fused_bytes": fb,
        "composed_bytes": cb,
        "ratio": fb / cb if cb else None,
        "fused_rows": len(fused),
        "composed_rows": len(composed),
    }


def verify_kernel_claim(watch, artifact_path: str,
                        slack: float = 1.5) -> dict:
    """Assert the ``BENCH_kernel_scale`` bandwidth claim against the live
    rows: the fused phase 1 moves fewer bytes than the composed one
    (ratio < 1), and the live ratio exceeds the committed byte-model
    ratio by at most ``slack`` x.  Returns ``{"live": ...,
    "claimed_ratio": ..., "n_docs": ...}``; raises ``AssertionError``
    when the claim does not hold live."""
    live = kernel_byte_ratio(watch)
    if live is None:
        raise AssertionError(
            "kernel claim check needs both a fused and a composed "
            "phase-1 row under search.query_phase")
    with open(artifact_path) as f:
        bench = json.load(f)
    rows = bench.get("rows", [])
    top = max((r.get("n_docs", 0) for r in rows), default=0)
    hbm = {r["variant"]: r["hbm_bytes"] for r in rows
           if r.get("n_docs") == top and "hbm_bytes" in r}
    claimed = None
    if "fused" in hbm and "composed" in hbm and hbm["composed"]:
        claimed = hbm["fused"] / hbm["composed"]
    assert live["ratio"] is not None and live["ratio"] < 1.0, (
        f"fused phase-1 moves MORE bytes than composed live: "
        f"{live['fused_bytes']:.3g} vs {live['composed_bytes']:.3g}")
    if claimed is not None:
        assert live["ratio"] <= claimed * slack, (
            f"live fused/composed byte ratio {live['ratio']:.3f} exceeds "
            f"the committed claim {claimed:.3f} by more than {slack}x")
    return {"live": live, "claimed_ratio": claimed, "n_docs": top}
