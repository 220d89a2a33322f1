"""repro_torch.obs on the host: the JAX package's host-only pins of
tests/test_obs.py and tests/test_profile.py, held against the port, and
the two packages side by side.

* histogram bucket math is EXACT (quantiles are ``bucket_le`` of the
  rank-``max(1, ceil(q*n))`` sample; no tolerance), and one seeded
  sequence of observations gives equal ``snapshot()`` dicts and the very
  same Prometheus text in both packages;
* tracer sampling is deterministic, the ring keeps the newest, and
  ``dump(clear=True)`` racing ``finish()`` loses and doubles nothing;
* the slow log captures by threshold or error, its ring is bounded and
  its JSONL sink keeps every capture;
* the build watch counts the ``nvcc`` builds of ``_build.load_library``
  per (region, signature) -- a library already loaded or already on disk
  is no build -- and after ``mark_steady()`` a region build fails
  ``check()`` while an unattributed one does not.  The builds here run a
  stand-in compiler (``g++``) through the real ``load_library``;
* ``repro_torch`` imports neither ``jax`` nor ``repro``.
"""

import json
import math
import os
import shutil
import stat
import subprocess
import sys
import textwrap
import threading
import time
import uuid

import numpy as np
import pytest

from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs import profile as jprofile
from repro.obs import stats as jstats
from repro_torch.kernels import _build
from repro_torch.obs import (NULL_TRACE, CompileWatch, Histogram,
                             MetricsExporter, MetricsRegistry, SlowLog,
                             Tracer, device_gauges, format_profile_tree,
                             format_segments_line, format_stats_line,
                             health_gauges, profile_from_trace,
                             prometheus_text, start_request_trace,
                             watch_region)

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


# ------------------------------------------------------------- histograms
def test_histogram_bucket_pins():
    reg = MetricsRegistry()
    h = reg.histogram("t.lat")
    samples = [1.5e-6, 3.0e-6, 1.0e-3, 0.25, 2.0]
    for s in samples:
        h.observe(s)
    assert h.count == len(samples)
    assert h.sum == pytest.approx(sum(samples))
    snap = h.snapshot()
    assert snap["min"] == min(samples) and snap["max"] == max(samples)
    ordered = sorted(samples)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        rank = max(1, math.ceil(q * len(samples)))
        assert h.quantile(q) == Histogram.bucket_le(ordered[rank - 1]), q
    for s in samples:
        assert Histogram.bucket_le(s) >= s


def test_histogram_edge_buckets():
    reg = MetricsRegistry()
    h = reg.histogram("t.edge")
    assert math.isnan(h.quantile(0.5))
    assert h.snapshot()["p50"] is None
    h.observe(0.0)
    assert h.quantile(0.0) == Histogram.bucket_le(0.0) == 1e-6
    h.observe(500.0)
    assert Histogram.bucket_le(500.0) == math.inf
    assert h.quantile(1.0) == math.inf
    assert h.snapshot()["max"] == 500.0
    with pytest.raises(ValueError, match="quantile"):
        h.quantile(1.5)


def test_histogram_single_observation_and_p999():
    reg = MetricsRegistry()
    h = reg.histogram("t.one")
    for q in (0.0, 0.5, 1.0):
        assert math.isnan(h.quantile(q))
    snap = h.snapshot()
    assert snap["count"] == 0
    assert snap["p50"] is snap["p999"] is None
    h.observe(0.0123)
    b = Histogram.bucket_le(0.0123)
    for q in (0.0, 0.25, 0.5, 0.999, 1.0):
        assert h.quantile(q) == b
    snap = h.snapshot()
    assert snap["p50"] == snap["p90"] == snap["p99"] == snap["p999"] == b
    assert snap["min"] == snap["max"] == snap["mean"] == 0.0123
    assert snap["count"] == 1 and snap["sum"] == 0.0123


def test_observe_many_matches_observe():
    reg = MetricsRegistry()
    a, b = reg.histogram("t.a"), reg.histogram("t.b")
    xs = list(np.random.default_rng(2).exponential(0.01, size=40))
    for x in xs:
        a.observe(x)
    b.observe_many(xs)
    b.observe_many([])
    assert a.snapshot() == b.snapshot()


def test_disabled_registry_records_nothing():
    reg = MetricsRegistry(enabled=False)
    c, g, h = reg.counter("t.c"), reg.gauge("t.g"), reg.histogram("t.h")
    c.inc()
    g.set(3.0)
    h.observe(0.5)
    h.observe_many([0.1, 0.2])
    assert c.value == 0 and g.value == 0.0 and h.count == 0
    reg.enabled = True
    c.inc()
    assert c.value == 1


def test_registry_series_and_totals():
    reg = MetricsRegistry()
    reg.counter("t.done", group=0).inc(3)
    reg.counter("t.done", group=1).inc(4)
    assert reg.counter("t.done", group=0) is reg.counter("t.done", group=0)
    assert reg.value("t.done", group=0) == 3
    assert reg.value("t.done", group=2, default=0) == 0
    assert reg.total("t.done") == 7
    assert reg.total("t.missing", default=-1) == -1
    assert reg.series("t.done") == {"group=0": 3, "group=1": 4}
    snap = reg.snapshot()
    assert snap["counters"]["t.done"] == {"group=0": 3, "group=1": 4}


# ------------------------------------------------- the two packages agree
def _drive(reg, seed):
    """One seeded sequence of records into ``reg``: labelled counters and
    gauges, histograms spanning every bucket and the overflow, and odd
    label values."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        g = int(rng.integers(0, 3))
        reg.counter("engine.requests.completed", group=g).inc(
            int(rng.integers(1, 5)))
        reg.gauge("engine.queue.depth", group=g).set(float(rng.random()))
        x = float(10.0 ** rng.uniform(-7.0, 2.5))
        reg.histogram("engine.dispatch.latency_s", group=g).observe(x)
        for w in rng.exponential(0.004, size=int(rng.integers(0, 6))):
            reg.histogram("engine.queue.wait_s").observe(w)
    reg.histogram("engine.batch.occupancy").observe(0.0)
    reg.histogram("engine.batch.occupancy").observe(1e9)
    reg.histogram("t.empty")
    reg.counter("engine.kernel_path", engine="fused", group=0).inc(7)
    reg.gauge("device.resident_bytes", device="cuda:0, id=\"x\"").set(12)
    reg.counter("2bad-name", **{"0key": "a=b,c"}).inc()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_and_prometheus_text_equal_across_packages(seed):
    mine, ref = MetricsRegistry(), jmetrics.MetricsRegistry()
    _drive(mine, seed)
    _drive(ref, seed)
    snap = mine.snapshot()
    assert snap == ref.snapshot()
    assert prometheus_text(snap) == jexport.prometheus_text(ref.snapshot())
    assert prometheus_text(snap, "x_") == jexport.prometheus_text(
        ref.snapshot(), "x_")
    for name in ("engine.requests.completed", "engine.queue.depth"):
        assert mine.series(name) == ref.series(name)
        assert mine.total(name) == ref.total(name)
    for q in (0.0, 0.3, 0.5, 0.999, 1.0):
        assert (mine.histogram("engine.queue.wait_s").quantile(q)
                == ref.histogram("engine.queue.wait_s").quantile(q))


def test_observe_many_buckets_equal_across_packages():
    """A batch through ``observe_many`` lands every sample in the same
    bucket in both packages: counts, min, max and every quantile equal.
    The port's sum is that of one ``observe`` a sample, bit for bit; the
    JAX package adds a batch with the built-in ``sum``, which rounds
    differently from Python 3.12 on, so its sum is held to 1e-12."""
    xs = np.random.default_rng(4).exponential(0.01, size=200).tolist()
    mine, ref, one = (MetricsRegistry(), jmetrics.MetricsRegistry(),
                      MetricsRegistry())
    for lo in range(0, len(xs), 7):
        mine.histogram("w").observe_many(xs[lo:lo + 7])
        ref.histogram("w").observe_many(xs[lo:lo + 7])
    for x in xs:
        one.histogram("w").observe(x)
    a, b = mine.histogram("w").snapshot(), ref.histogram("w").snapshot()
    assert a == one.histogram("w").snapshot()
    assert {k: v for k, v in a.items() if k not in ("sum", "mean")} \
        == {k: v for k, v in b.items() if k not in ("sum", "mean")}
    assert a["sum"] == pytest.approx(b["sum"], rel=1e-12, abs=0)


def test_derived_gauges_equal_across_packages():
    health = {"status": "yellow", "up_groups": 1, "n_groups": 2,
              "pending_requests": 3, "in_flight_restores": 0,
              "pending_maintenance": [{"group": 1}], "generation": 4}
    device = {"total_bytes": 100, "sections": {"base": 60, "segments": 40},
              "per_device": {"cuda:0": 100}}
    mine, ref = MetricsRegistry(), jmetrics.MetricsRegistry()
    health_gauges(mine, health)
    jexport.health_gauges(ref, health)
    device_gauges(mine, device, group=0)
    jexport.device_gauges(ref, device, group=0)
    assert mine.snapshot() == ref.snapshot()
    assert mine.value("cluster.health.status") == 1


_TRACE = {
    "name": "query", "trace_id": 3, "t0": 10.0, "t1": 10.25,
    "duration_s": 0.25, "attrs": {"stream": "s", "error": "boom"},
    "spans": [
        {"name": "queue_wait", "t0": 10.0, "t1": 10.01,
         "duration_s": 0.01, "attrs": {"group": 0}, "events": []},
        {"name": "dispatch", "t0": 10.01, "t1": 10.25, "duration_s": 0.24,
         "attrs": {"group": 1, "batch_size": 4},
         "events": [{"name": "spill", "t": 10.02,
                     "attrs": {"from_group": 0, "to_group": 1}}]},
        {"name": "events", "t0": 10.1, "t1": None, "duration_s": None,
         "attrs": {}, "events": []},
    ]}


def test_profile_views_equal_across_packages():
    mine = profile_from_trace(_TRACE)
    assert mine == jprofile.profile_from_trace(_TRACE)
    assert [c["name"] for c in mine["children"]] == [
        "queue_wait", "dispatch", "events"]
    assert mine["children"][1]["children"][0]["name"] == "event:spill"
    assert format_profile_tree(mine) == jprofile.format_profile_tree(mine)
    assert "event:spill" in format_profile_tree(mine)


def test_stats_lines_equal_across_packages():
    hist = {"p50": 0.002, "p99": 0.0071}
    eng = {"pending": 2, "requests": {"completed": 5, "submitted": 7,
                                      "failed": 1},
           "batches": {"p50": 0.25}, "kernel_path": {"fused": 3, "codes": 2},
           "queue_wait_s": hist, "dispatch_latency_s": {"p50": None,
                                                        "p99": math.inf}}
    cluster = {"n_groups": 2, "requests": {"completed": 9, "submitted": 9,
                                           "failed": 0},
               "routing": {"spills": 1, "failover_resubmits": 0},
               "groups": {0: {**eng, "health": "up"},
                          1: {**eng, "health": "down",
                              "queue_wait_s": {"p50": None, "p99": None},
                              "dispatch_latency_s": hist}}}
    segs = {"n_docs": 60, "segments": [
        {"rows": 16, "tombstones": 1}, {"rows": 8, "tombstones": 0}],
        "n_active": 8, "active_tombstones": 2, "n_reclaimed": 3,
        "n_tombstones": 6}
    for st in (eng, cluster):
        assert format_stats_line(st) == jstats.format_stats_line(st)
    assert "kernel=codes:2/fused:3" in format_stats_line(eng)
    assert format_segments_line(segs) == jstats.format_segments_line(segs)
    assert format_segments_line({"n_ids": 5}) == "segments base=5"


# ---------------------------------------------------------------- tracing
def test_tracer_sampling_deterministic():
    tr = Tracer(sample=0.25)
    kept = [bool(tr.start("q")) for _ in range(8)]
    assert kept == [True, False, False, False, True, False, False, False]
    st = tr.stats()
    assert st["seen"] == 8 and st["sampled"] == 2
    assert not NULL_TRACE
    assert NULL_TRACE.span("x").end() is NULL_TRACE
    with pytest.raises(ValueError, match="sample"):
        Tracer(sample=0.0)
    with pytest.raises(ValueError, match="capacity"):
        Tracer(capacity=0)


def test_trace_ring_retention():
    tr = Tracer(capacity=2, sample=1.0)
    for _ in range(5):
        t = tr.start("q")
        t.span("work").end()
        t.finish()
        t.finish()                                 # idempotent
    dump = tr.dump()
    assert [d["trace_id"] for d in dump] == [4, 5]
    assert tr.dump(clear=True) and tr.dump() == []


def test_trace_events_attach_to_open_span():
    tr = Tracer(sample=1.0)
    t = tr.start("q", stream=1)
    s = t.span("dispatch")
    t.event("spill", to_group=1)
    s.end()
    t.event("late")                                # no open span
    t.finish(error="x")
    (d,) = tr.dump()
    assert d["attrs"] == {"stream": 1, "error": "x"}
    assert [e["name"] for e in d["spans"][0]["events"]] == ["spill"]
    assert d["spans"][1]["name"] == "events"


def test_tracer_dump_clear_races_retain():
    n_threads, per_thread = 4, 200
    total = n_threads * per_thread
    tr = Tracer(capacity=total, sample=1.0)
    stop = threading.Event()
    collected, coll_lock = [], threading.Lock()
    errors = []

    def dumper():
        try:
            while not stop.is_set():
                out = tr.dump(clear=True)
                assert len(out) <= total
                with coll_lock:
                    collected.extend(out)
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors.append(exc)

    def producer():
        try:
            for _ in range(per_thread):
                t = tr.start("q")
                t.span("work").end()
                t.finish()
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors.append(exc)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        dump_thread = threading.Thread(target=dumper)
        producers = [threading.Thread(target=producer)
                     for _ in range(n_threads)]
        dump_thread.start()
        for th in producers:
            th.start()
        for th in producers:
            th.join(timeout=60)
        stop.set()
        dump_thread.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not dump_thread.is_alive()
    assert not any(th.is_alive() for th in producers)
    collected.extend(tr.dump(clear=True))
    assert not errors
    ids = sorted(d["trace_id"] for d in collected)
    assert ids == list(range(1, total + 1))
    assert tr.stats()["retained"] == 0


# ----------------------------------------------------------------- slow log
def test_slowlog_ring_bound_and_jsonl_sink(tmp_path):
    path = tmp_path / "slow.jsonl"
    slog = SlowLog(threshold_s=0.0, capacity=4, path=str(path),
                   metrics=MetricsRegistry())
    for i in range(7):
        t = slog.start("query", n=i)
        t.span("work").end()
        t.finish()
    st = slog.stats()
    assert st["seen"] == st["captured"] == 7
    assert st["retained"] == 4
    assert [r["attrs"]["n"] for r in slog.dump()] == [3, 4, 5, 6]
    slog.close()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(lines) == 7
    assert all("profile" in ln and "slowlog" in ln for ln in lines)
    assert slog.dump(clear=True) and slog.dump() == []
    with pytest.raises(ValueError, match="threshold"):
        SlowLog(threshold_s=-1.0)
    with pytest.raises(ValueError, match="capacity"):
        SlowLog(capacity=0)


def test_slowlog_threshold_filters_fast_requests():
    reg = MetricsRegistry()
    slog = SlowLog(threshold_s=10.0, metrics=reg)
    t = slog.start("query")
    t.finish()
    st = slog.stats()
    assert st["seen"] == 1 and st["captured"] == 0
    t = slog.start("query")
    t.finish(error="boom")
    st = slog.stats()
    assert st["captured"] == st["errors"] == 1 and st["slow"] == 0
    assert reg.value("slowlog.seen") == 2
    assert reg.value("slowlog.errors") == 1


def test_start_request_trace_fans_out_to_both_sinks():
    """A head-sampled request is ONE trace retained by the tracer ring and
    the slow log; an unsampled one gets a slow-log-only skeleton."""
    assert start_request_trace(None, None) is NULL_TRACE
    tr = Tracer(sample=0.5)
    slog = SlowLog(threshold_s=0.0, metrics=MetricsRegistry())
    traces = [start_request_trace(tr, slog, "query") for _ in range(4)]
    for t in traces:
        t.finish()
    assert tr.stats()["sampled"] == 2 and len(tr.dump()) == 2
    st = slog.stats()
    assert st["seen"] == st["captured"] == 4


# ---------------------------------------------------------------- exporters
def test_prometheus_text_exposition():
    reg = MetricsRegistry()
    reg.counter("engine.requests.completed", group=0).inc(5)
    reg.gauge("engine.queue.depth").set(3.0)
    h = reg.histogram("engine.queue.wait_s")
    h.observe_many([0.001, 0.002, 0.004])
    lines = prometheus_text(reg.snapshot()).splitlines()
    assert "# TYPE repro_engine_requests_completed_total counter" in lines
    assert 'repro_engine_requests_completed_total{group="0"} 5' in lines
    assert "repro_engine_queue_depth 3.0" in lines
    assert "repro_engine_queue_wait_s_count 3" in lines
    for q in ("0.50", "0.90", "0.99", "0.999"):
        assert any(f'quantile="{q}"' in ln for ln in lines), q
    (sum_line,) = [ln for ln in lines
                   if ln.startswith("repro_engine_queue_wait_s_sum")]
    assert float(sum_line.split()[-1]) == pytest.approx(0.007)


def test_metrics_exporter_history_and_jsonl(tmp_path):
    path = tmp_path / "metrics.jsonl"
    reg = MetricsRegistry()
    c = reg.counter("t.ticks")
    exp = MetricsExporter(reg, path=str(path), capacity=3)
    for _ in range(5):
        c.inc()
        exp.collect()
    hist = exp.history()
    assert len(hist) == 3
    ts = [h["t_monotonic"] for h in hist]
    assert ts == sorted(ts)
    assert [h["metrics"]["counters"]["t.ticks"][""] for h in hist] \
        == [3, 4, 5]
    exp.stop()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(lines) == 5
    assert lines[0]["metrics"]["counters"]["t.ticks"][""] == 1
    assert "repro_t_ticks_total 5" in exp.text()
    with pytest.raises(ValueError, match="capacity"):
        MetricsExporter(reg, capacity=0)
    with pytest.raises(ValueError, match="interval"):
        MetricsExporter(reg, interval_s=0.0)


def test_metrics_exporter_background_thread():
    reg = MetricsRegistry()
    exp = MetricsExporter(reg, interval_s=0.01)
    exp.start()
    with pytest.raises(RuntimeError, match="already started"):
        exp.start()
    deadline = time.monotonic() + 5.0
    while not exp.history() and time.monotonic() < deadline:
        time.sleep(0.005)
    exp.stop()
    assert exp.history()
    n = len(exp.history())
    time.sleep(0.05)
    assert len(exp.history()) == n


# ---------------------------------------------------- build watch (nvcc)
_FAKE_NVCC = """#!{python}
import subprocess, sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
srcs = [a for a in args if a.endswith(".cu")]
sys.exit(subprocess.run(["{cxx}", "-x", "c++", "-shared", "-fPIC", "-o",
                         out, *srcs]).returncode)
"""


@pytest.fixture()
def fake_nvcc(tmp_path, monkeypatch):
    """``_build.load_library`` with a stand-in compiler (the host C++
    compiler, nvcc's flags dropped) and a build directory of the test's
    own -> a function building a fresh tiny library ``tag`` (the build
    cache keys on the name and the sources)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, cxx=cxx))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    run = uuid.uuid4().hex[:8]

    def load(tag):
        src = tmp_path / f"{tag}.cu"
        if not src.exists():
            src.write_text(f'extern "C" int probe(void) {{ return '
                           f'{len(tag)}; }}\n')
        return _build.load_library(f"obs_{run}_{tag}", [src])

    yield load
    for name in [n for n in _build._libs if n.startswith(f"obs_{run}_")]:
        del _build._libs[name]


def test_compile_watch_counts_builds_and_steady_state(fake_nvcc):
    reg = MetricsRegistry()
    w = CompileWatch(metrics=reg)
    with w.region("fn", sig=((3,),)):
        assert fake_nvcc("a").probe() == 1
    assert w.compiles_total == 1
    with w.region("fn", sig=((3,),)):
        fake_nvcc("a")                             # loaded: no build
    assert w.compiles_total == 1
    with w.region("fn", sig=((4,),)):
        fake_nvcc("bb")                            # a new library
    assert w.compiles_total == 2
    st = w.stats()
    assert st["by_function"] == {"fn": 2}
    assert st["signatures"] == 2 and not st["steady"]
    assert reg.value("compile.total", fn="fn") == 2
    h = reg.histogram("compile.duration_s", fn="fn")
    assert h.count == 2 and h.sum > 0.0

    w.mark_steady()
    w.check()
    assert w.compiles_steady_state == 0
    with w.region("fn", sig=((5,),)):
        with watch_region("inner", sig=("x",)):    # innermost wins
            fake_nvcc("ccc")
    assert w.compiles_steady_state == 1
    (ev,) = w.stats()["steady_events"]
    assert ev["fn"] == "inner" and ev["sig"] == ["x"] and not ev["repeat_sig"]
    assert reg.value("compile.steady_state", fn="inner") == 1
    with pytest.raises(RuntimeError, match="steady-state recompile"):
        w.check()
    w.reset()
    assert w.compiles_total == 0 and not w.stats()["steady"]


def test_compile_watch_library_on_disk_is_no_build(fake_nvcc):
    """A library another process already built loads without a build."""
    w = CompileWatch(metrics=MetricsRegistry())
    with w.region("fn"):
        fake_nvcc("d")
        for name in [n for n in _build._libs if n.endswith("_d")]:
            del _build._libs[name]                 # as a fresh process
        assert fake_nvcc("d").probe() == 1
    assert w.compiles_total == 1


def test_compile_watch_unattributed_never_steady(fake_nvcc):
    w = CompileWatch(metrics=MetricsRegistry())
    w.mark_steady()
    fake_nvcc("e")                                 # no region on this thread
    assert w.compiles_steady_state == 0
    w.check()


class _BuildingIndex:
    """An index whose search loads the library ``tag`` first, as a
    kernel's wrapper does at its launch: the first search builds it."""

    def __init__(self, inner, load, tag):
        self.inner, self.load, self.tag = inner, load, tag

    def search(self, q, **kw):
        self.load(self.tag)
        return self.inner.search(q, **kw)


def test_engine_dispatch_build_attributed_and_steady(fake_nvcc):
    from repro_torch.core import VectorIndex
    from repro_torch.serve import BatchedSearchEngine

    rng = np.random.default_rng(0)
    index = _BuildingIndex(VectorIndex.build(
        rng.normal(size=(40, 8)).astype(np.float32), device="cpu"),
        fake_nvcc, "g")
    reg = MetricsRegistry()
    w = CompileWatch(metrics=reg)
    eng = BatchedSearchEngine(index, batch_size=3, k=4, page=40, trim=None,
                              engine="codes", metrics=reg, compile_watch=w)
    q = rng.normal(size=(5, 8)).astype(np.float32)
    try:
        eng.search(q[0], timeout=60)               # warm-up: one build
        st = eng.stats()["compile"]
        assert st["compiles_total"] == 1
        assert st["by_function"] == {"engine.dispatch": 1}
        w.mark_steady()
        for x in q[1:3]:
            eng.search(x, timeout=60)
        assert w.compiles_steady_state == 0
        w.check()
        index.tag = "hh"                           # a library not built yet
        eng.search(q[3], timeout=60)
    finally:
        eng.close()
    (ev,) = w.stats()["steady_events"]
    assert ev["fn"] == "engine.dispatch"
    assert ev["sig"] == ["(3, 8)", "float32", "codes", "4", "40", "gather"]
    with pytest.raises(RuntimeError, match="steady-state recompile"):
        w.check()
    assert reg.value("compile.steady_state", fn="engine.dispatch") == 1
    assert eng.stats()["compile"]["compiles_steady_state"] == 1


# ------------------------------------------------------------ import guard
def test_port_imports_neither_jax_nor_reference():
    """Every module of repro_torch, the obs package included, imported in
    a fresh interpreter: neither ``jax`` nor ``repro`` gets loaded."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = sorted(m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch."))
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(len(names))
        print(",".join(names))
        print(",".join(bad))
    """)
    env = {**os.environ, "PYTHONPATH": _SRC}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, names, bad = (out.stdout.splitlines() + [""])[:3]
    assert int(count) >= 40
    names = set(names.split(","))
    for mod in ("metrics", "tracing", "profile", "slowlog", "export",
                "compile_watch", "stats"):
        assert f"repro_torch.obs.{mod}" in names, mod
    assert "repro_torch.serve.engine" in names
    assert "repro_torch.dist.shard_index" in names
    for mod in ("translog", "snapshot", "recovery", "durable"):
        assert f"repro_torch.store.{mod}" in names, mod
    assert int(count) == len(names)
    assert bad == "", bad
