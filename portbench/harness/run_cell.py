"""One run of one cell: make the inputs from the seed, build and warm the
system, drive the window, check the answers against the reference, and
return the result line.  ``execute`` takes the device, so the tests drive
it on the CPU at a small size; ``run.py`` drives it on the card."""

from __future__ import annotations

import copy
import gc
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference.search_ref import NUMBERS, Layout, Reference
from . import data, drive, stats, traffic
from .faults import Faulty
from .spec import ROOT, Spec, read_metrics
from .system import System
from .trace import DeviceTrace, profiled

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRAIN_S = 60.0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def deep_update(base: dict, upd: Optional[dict]) -> dict:
    out = copy.deepcopy(base)
    for k, v in (upd or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_update(out[k], v)
        else:
            out[k] = v
    return out


class Run:
    """What a per-layer metric reads: the cell's files, the per-query
    records, the program's counters at the window's edges, the samples
    taken once a second, and the device trace (``None`` untraced)."""

    def __init__(self, spec: Spec, config: dict, mix: dict):
        self.spec, self.config, self.mix = spec, config, mix
        self.rec: Optional[drive.Recorder] = None
        self.n_window = 0
        self.t0 = self.t_close = 0.0
        self.seconds = 0.0
        self.counters0: dict = {}
        self.counters1: dict = {}
        self.samples: Dict[str, List[float]] = {}
        self.trace: Optional[DeviceTrace] = None
        self.gc_pauses: List[tuple] = []
        self.n_groups = 1

    def hist_delta(self, name: str):
        """(count, sum) of a histogram over the window, every label."""
        c = s = 0.0
        h0 = self.counters0.get("histograms", {}).get(name, {})
        for label, snap in self.counters1.get("histograms", {}).get(
                name, {}).items():
            old = h0.get(label, {"count": 0, "sum": 0.0})
            c += snap["count"] - old["count"]
            s += snap["sum"] - old["sum"]
        return c, s

    def counter_delta(self, name: str) -> float:
        c0 = self.counters0.get("counters", {}).get(name, {})
        return sum(v - c0.get(label, 0) for label, v in
                   self.counters1.get("counters", {}).get(name, {}).items())

    def window_slice(self) -> slice:
        return slice(0, self.n_window)

    @property
    def open_loop(self) -> bool:
        return self.mix["loop"] == "open"


class _GcClock:
    """Times each run of the cyclic garbage collector, by
    ``gc.callbacks``, as (generation, start, stop) on the monotonic
    clock."""

    def __init__(self):
        self.pauses: List[tuple] = []
        self._t: Optional[float] = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.monotonic()
        elif self._t is not None:
            self.pauses.append((info["generation"], self._t,
                                time.monotonic()))
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


class _Sampler:
    """Reads ``fn()`` once a second on a thread of its own, and once more
    when stopped."""

    def __init__(self, fn, period: float = 1.0):
        self.fn, self.period = fn, period
        self.values: List[float] = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.period):
            self.values.append(float(self.fn()))

    def start(self):
        self._t.start()

    def stop(self):
        self._stop.set()
        self._t.join(5.0)
        self.values.append(float(self.fn()))


def _generations(system) -> float:
    """Mean count of sealed segments over the replica groups."""
    gs = system.groups()
    return sum(getattr(g, "n_segments", 0) for g in gs) / len(gs)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            root=ROOT, device="cuda", overrides: Optional[dict] = None,
            fault: str = "none", setup_t0: Optional[float] = None,
            setup_offset: float = 0.0) -> dict:
    """Run one cell -> ``{"result": the result line (dict), "checks":
    {number: (value, limit)}, "run": the Run,
    "reference": the Reference, "judged": (queries, bulks acknowledged,
    bulks begun) of the judged sample, "setup_parts": seconds by part}``.
    ``setup_t0`` is the monotonic time the process's set-up is counted
    from and ``setup_offset`` the seconds the process ran before it;
    ``overrides`` are merged into the configuration and the mix (the CPU
    tests' small sizes, the sweep's rates); ``fault`` plants one of
    :data:`.faults.FAULTS` under the timed path."""
    t_setup = time.monotonic() if setup_t0 is None else setup_t0
    spec = Spec(workload, root)
    overrides = overrides or {}
    cfg = deep_update(spec.config, overrides.get("config"))
    mix = deep_update(spec.mix, overrides.get("mix"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    run = Run(spec, cfg, mix)

    # ------------------------------------------------------------ inputs
    corpus = cfg["corpus"]
    N, n_feat = int(corpus["docs"]), int(corpus["features"])
    prec = int(cfg["encoder"]["precision"])
    trim = cfg.get("trim")
    margin = float(corpus["snap_margin"])
    k, bsz = int(cfg["k"]), int(cfg["batcher"]["batch_size"])
    setup_parts = {"before_inputs_s": setup_offset + time.monotonic()
                   - t_setup}
    t_part = time.monotonic()
    g = data.generator(seed, dev)
    base = data.unit_rows(N, n_feat, g, dev, prec, trim, margin)

    writes = mix.get("writes")
    w_off = (traffic.write_offsets(float(writes["period_s"]),
                                   float(writes["start_s"]), seconds)
             if writes else np.zeros(0))
    rows_per_bulk = int(writes["rows"]) if writes else 0
    n_bulks = (1 + len(w_off)) if writes else 0      # bulk 0 warms
    app = (data.unit_rows(n_bulks * rows_per_bulk, n_feat, g, dev, prec,
                          trim, margin) if n_bulks else base[:0])
    bulks_np = [app[j * rows_per_bulk:(j + 1) * rows_per_bulk].cpu().numpy()
                for j in range(n_bulks)]

    qmix = mix["queries"]
    if mix["loop"] == "open":
        offsets = traffic.poisson_offsets(float(mix["rate_qps"]), seconds,
                                          seed)
        nq = len(offsets)
    else:
        offsets = None
        nq = int(mix["pool"])
    bulk_due = (np.concatenate([[-1e9], w_off]) if n_bulks else None)
    plan = traffic.plan_queries(
        nq, N, seed, int(mix.get("streams", 0)), due=offsets,
        bulk_due=bulk_due, bulk_rows=rows_per_bulk,
        appended_share=float(qmix.get("appended_share", 0.0)),
        lag_s=float(qmix.get("appended_lag_s", 0.5)))
    src = torch.as_tensor(plan.src, device=dev)
    rows = base[src]
    if n_bulks:
        bt = torch.as_tensor(plan.bulk, device=dev)
        arow = app[(bt.clamp(min=0) * rows_per_bulk + src).clamp(
            max=max(app.shape[0] - 1, 0))]
        rows = torch.where((bt >= 0)[:, None], arow, rows)
    noise = float(qmix["noise"])
    queries_t = data.noisy_copies(rows, noise, g, prec, trim, margin)
    del rows
    queries_np = queries_t.cpu().numpy()
    n_warm = int(mix.get("warm_batches", 2)) * bsz
    wsrc = torch.randint(0, N, (n_warm,), generator=g, device=dev)
    warm_np = data.noisy_copies(base[wsrc], noise, g, prec, trim,
                                margin).cpu().numpy()

    # ------------------------------------------------------ system, warm
    _sync(dev)
    setup_parts["inputs_s"] = time.monotonic() - t_part
    t_part = time.monotonic()
    wrap = (None if fault == "none" else (lambda idx: Faulty(idx, fault)))
    system = System(cfg, base, dev, wrap)
    _sync(dev)
    setup_parts["build_s"] = time.monotonic() - t_part
    t_part = time.monotonic()

    def warm():
        for grp in range(system.n_groups):
            for a in range(0, n_warm, bsz):
                futs = [system.submit_to_group(q, grp)
                        for q in warm_np[a:a + bsz]]
                for f in futs:
                    f.result(timeout=600)

    warm()
    if n_bulks:
        system.add(bulks_np[0])
        warm()
    _sync(dev)
    setup_parts["warm_s"] = time.monotonic() - t_part

    spans: Optional[list] = [] if trace else None
    writer = (drive.Writer(system.add, bulks_np[1:], w_off, spans)
              if n_bulks else None)
    rec = drive.Recorder(nq, k, writer)
    run.rec = rec
    threads = int(mix.get("senders", 1))
    if offsets is not None:
        senders = drive.Senders(system, rec, queries_np, threads, writer,
                                spans)
    else:
        loop = drive.ClosedLoop(system, rec, queries_np,
                                int(mix["sessions"]), threads, writer, spans)
        senders = loop.senders
    sampler = _Sampler(lambda: _generations(system))
    run.n_groups = system.n_groups
    run.counters0 = system.registry.snapshot()
    setup_s = setup_offset + time.monotonic() - t_setup

    # ------------------------------------------------------------ window
    with profiled(trace) as holder, _GcClock() as gclock:
        w0 = time.time_ns()
        t0 = time.monotonic()
        if writer is not None:
            writer.start(t0)
        sampler.start()
        if offsets is not None:
            drive.open_loop(senders, rec, offsets, plan.stream, t0)
        else:
            loop.start(t0, seconds)
        rest = t0 + seconds - time.monotonic()
        if rest > 0:
            time.sleep(rest)
        w1 = time.time_ns()
        run.counters1 = system.registry.snapshot()
        sampler.stop()
        if writer is not None:
            writer.join(DRAIN_S)
    run.t0, run.t_close, run.seconds = t0, t0 + seconds, seconds
    run.n_window = rec.count
    run.samples["generations"] = sampler.values
    run.gc_pauses = [p for p in gclock.pauses if t0 <= p[1] < run.t_close]
    if holder.ops is not None:
        run.trace = DeviceTrace(holder.ops, w0, w1, spans or [])

    senders.close(DRAIN_S)
    drive.wait_answers(rec, DRAIN_S)
    mem_peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
    system.close()
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ----------------------------------------------------- end to end
    n = rec.count
    answered = rec.ok[:n]
    failed = int(n - answered.sum())
    run.latency_ms = stats.latencies_ms(rec.due[:n], rec.done[:n], answered)
    run.qps = stats.window_qps(rec.done[:n], answered, run.t_close, seconds)
    run.setup_s = setup_s

    # ----------------------------------------------------------- check
    chk = cfg["check"]
    n_judge = min(int(chk["judged"]), n)
    pick = np.sort(traffic.host_rng(seed, 3).choice(n, n_judge,
                                                    replace=False))
    missing = int((~rec.ok[pick]).sum())
    ref = Reference(
        Layout(scorer=chk["scorer"], shards=int(cfg["layout"].get(
            "shards", 1)), page=int(cfg["page"]), k=k, precision=prec,
            trim=trim, band_rel=float(chk["band_rel"])),
        base, [app[j * rows_per_bulk:(j + 1) * rows_per_bulk]
               for j in range(n_bulks)])
    extra = 1 if n_bulks else 0
    judged = (queries_t[torch.as_tensor(pick, device=dev)],
              rec.n_req[pick] + extra, rec.n_pos[pick] + extra)
    numbers = ref.judge(judged[0], rec.ids[pick], rec.scores[pick],
                        judged[1], judged[2])
    limits = chk["limits"]
    checks = {key: (numbers[key], float(limits[key])) for key in NUMBERS}
    checks["judged_missing"] = (float(missing), 0.0)
    checks["failed"] = (float(failed), 0.0)
    correct = all(v <= lim for v, lim in checks.values())

    # --------------------------------------------------------- result
    metrics = read_metrics(spec, run,
                           spec.per_layer if trace else spec.end_to_end)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": spec.chips, "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(correct), "attempted": int(n),
              "failed": failed, "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {key: {"value": v, "limit": lim}
                        for key, (v, lim) in checks.items()}
    return {"result": result, "checks": checks, "run": run, "reference": ref, "judged": judged,
            "setup_parts": setup_parts}
