"""repro_torch's serving-path timeline (``registry.timeline``), on the CPU.

* the ring is bounded: a wrapped ring counts each overwritten span in
  ``timeline.dropped``;
* off while no profiler records: nothing is recorded, no ring allocated;
* its anchor maps the spans onto the profiler's clock: every operator the
  batcher thread runs lies inside its batch's ``search.launch`` ..
  ``search.answer_wait`` interval, mapped, within 0.1 ms;
* the five batcher spans tile each worker loop and share the batch's id,
  which the requests' trace spans carry, and ``search.launch`` plus
  ``search.answer_wait`` is that batch's dispatch-latency sample;
* a merge rebuild an add races is thrown away, counted in
  ``maintenance.merges.discarded`` and marked ``discarded``;
* one ``router.pick`` span per routed submit, on the submitting thread;
* under a sink, a flat search and a segmented one close the same
  ``search.*`` phases in order, for every engine of the table, the
  segmented one with ``search.merge`` before its rescore;
* the Prometheus text, the JSONL history and the diagnostics bundle are
  unchanged by the snapshot's ``timeline`` section.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from repro_torch.cluster import (ClusterEngine, MaintenanceDaemon,
                                 TieredMergePolicy)
from repro_torch.core import VectorIndex
from repro_torch.core.search import ENGINES
from repro_torch.dist import ShardedVectorIndex
from repro_torch.obs import (MetricsExporter, MetricsRegistry, Tracer,
                             diagnostics_bundle, prometheus_text)
from repro_torch.obs.tracing import (_PACK_ROW, _SPAN_ROW, MERGE_KINDS,
                                     MERGE_OUTCOMES, SPAN_NAMES, Timeline,
                                     phase_clock)
from repro_torch.serve import BatchedSearchEngine

N_DOCS, N_FEAT = 60, 16
WAIT = 30
KW = dict(batch_size=4, k=5, page=N_DOCS, trim=None, engine="codes")
LOOP = ("batcher.wait", "batcher.form", "search.launch",
        "search.answer_wait", "batcher.deliver")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(0)
    return VectorIndex.build(rng.normal(size=(N_DOCS, N_FEAT))
                             .astype(np.float32), device="cpu")


@pytest.fixture()
def queries():
    return np.random.default_rng(1).normal(
        size=(12, N_FEAT)).astype(np.float32)


def _profiling(all_threads: bool = False):
    """A CPU profiler session; ``all_threads`` records the operators of
    threads begun before it too (the batcher's)."""
    cfg = _ExperimentalConfig(profile_all_threads=all_threads)
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=cfg)


def _spans(snap):
    """The timeline section's spans as dicts, oldest start first."""
    sp = snap["spans"]
    return [{"name": snap["names"][sp["name"][i]],
             **{f: int(sp[f][i]) for f in sp if f != "name"}}
            for i in range(len(sp["t0_ns"]))]


def _serve_one_by_one(eng, queries):
    for q in queries:
        eng.search(q, timeout=WAIT)


def test_ring_wraps_and_counts_dropped():
    reg = MetricsRegistry()
    tl = Timeline(reg, capacity=8)
    with _profiling():
        assert tl.recording()
        for i in range(11):
            tl.record("router.pick", 10 * i, 10 * i + 5)
    snap = tl.snapshot()
    assert snap["dropped"] == 3 == reg.value("timeline.dropped")
    assert list(snap["spans"]["t0_ns"]) == [10 * i for i in range(3, 11)]
    assert len(set(snap["spans"]["span"])) == 8
    assert snap["names"] == list(SPAN_NAMES)
    # the packed row and the arrays' row agree field for field
    assert _PACK_ROW.__self__.size == _SPAN_ROW.itemsize
    tl.record("search.phase1", -5, 7, span=99, parent=98, batch=97,
              group=3, arg0=4, arg1=2**31 - 1)
    last = tl.snapshot()["spans"]
    (i,) = np.flatnonzero(last["span"] == 99)
    got = {f: int(last[f][i]) for f in last}
    assert got == {"t0_ns": -5, "t1_ns": 7,
                   "name": SPAN_NAMES.index("search.phase1"), "group": 3,
                   "thread": threading.get_native_id(), "span": 99,
                   "parent": 98, "batch": 97, "arg0": 4, "arg1": 2**31 - 1}


def test_nothing_recorded_or_allocated_without_a_profiler(index, queries):
    reg = MetricsRegistry()
    eng = BatchedSearchEngine(index, metrics=reg, **KW)
    try:
        _serve_one_by_one(eng, queries[:4])
    finally:
        eng.close()
    assert not reg.timeline.recording()
    assert reg.timeline._rows is None and reg.timeline.snapshot() is None
    assert "timeline" not in reg.snapshot()
    assert phase_clock() is None
    # a profiler alone records nothing outside an engine's sink, and a
    # disabled registry nothing at all
    off = MetricsRegistry(enabled=False)
    bare = BatchedSearchEngine(index, metrics=off, **KW)
    try:
        with _profiling():
            index.search(queries[:2], k=5, page=N_DOCS, engine="codes")
            assert phase_clock() is None
            _serve_one_by_one(bare, queries[:2])
    finally:
        bare.close()
    assert off.timeline._rows is None


def test_anchor_maps_spans_onto_the_profilers_clock(index, queries):
    reg = MetricsRegistry()
    eng = BatchedSearchEngine(index, metrics=reg, **KW)
    try:
        with _profiling(all_threads=True) as prof:
            _serve_one_by_one(eng, queries)
            snap = reg.snapshot()["timeline"]
    finally:
        eng.close()
    off = snap["anchor"]["wall_ns"] - snap["anchor"]["monotonic_ns"]
    spans = _spans(snap)
    by_batch = {}
    for s in spans:
        by_batch.setdefault(s["batch"], {})[s["name"]] = s
    # a batch's operators run from its launch to the end of its copies
    bounds = sorted((b["search.launch"]["t0_ns"] + off,
                     b["search.answer_wait"]["t1_ns"] + off)
                    for b in by_batch.values() if "search.launch" in b)
    assert len(bounds) == len(queries)
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::")]
    tol = 100_000                                    # 0.1 ms
    lo, hi = bounds[0][0] - tol, bounds[-1][1] + tol
    ops = [o for o in ops if lo <= o[0] <= hi]
    assert len(ops) >= 3 * len(queries)
    starts = np.array([a for a, _ in bounds])
    hit = np.zeros(len(bounds), int)
    for a, b in ops:
        j = int(np.searchsorted(starts, a + tol, side="right")) - 1
        assert j >= 0, (a, bounds[0])
        assert bounds[j][0] - tol <= a and b <= bounds[j][1] + tol
        hit[j] += 1
    assert (hit > 0).all()


def test_batcher_spans_tile_the_loop_and_share_a_batch(index, queries):
    reg = MetricsRegistry()
    eng = BatchedSearchEngine(index, metrics=reg, tracer=Tracer(sample=1.0),
                              **KW)
    try:
        with _profiling():
            _serve_one_by_one(eng, queries)
            snap = reg.snapshot()["timeline"]
    finally:
        eng.close()
    traces = eng.tracer.dump()
    spans = _spans(snap)
    loop = sorted((s for s in spans if s["name"] in LOOP),
                  key=lambda s: (s["t0_ns"], s["t1_ns"]))
    assert len({s["thread"] for s in loop}) == 1
    # edge to edge, from the first recorded batch's form to the last
    # batch's deliver
    assert loop[0]["name"] == "batcher.form"
    for a, b in zip(loop, loop[1:]):
        assert a["t1_ns"] == b["t0_ns"], (a, b)
    names = [s["name"] for s in loop]
    assert names == list(LOOP[1:]) + list(LOOP) * (len(queries) - 1)
    batches = {}
    for s in spans:
        batches.setdefault(s["batch"], []).append(s)
    assert len(batches) == len(queries)
    hist = reg.snapshot()["histograms"]["engine.dispatch.latency_s"][""]
    total = 0.0
    for bid, ss in batches.items():
        got = {s["name"]: s for s in ss}
        launch, copies = got["search.launch"], got["search.answer_wait"]
        # the index's phases are the launch's children
        kids = [s for s in ss if s["parent"] == launch["span"]]
        assert [s["name"] for s in kids] == ["search.encode",
                                             "search.phase1",
                                             "search.rescore"]
        assert got["search.phase1"]["arg0"] == 1      # one shard
        both = (launch["t1_ns"] - launch["t0_ns"]
                + copies["t1_ns"] - copies["t0_ns"]) * 1e-9
        total += both
        # the request's trace spans carry the batch id, and its dispatch
        # span takes the same clock reads as the histogram's sample
        tr = [t for t in traces
              if t["spans"] and t["spans"][0]["attrs"]["batch"] == bid]
        assert len(tr) == 1
        disp = {s["name"]: s for s in tr[0]["spans"]}["dispatch"]
        assert all(s["attrs"]["batch"] == bid for s in tr[0]["spans"])
        assert abs(disp["duration_s"] - both) < 1e-8
    recorded = [s for s in traces if s["spans"]]
    assert hist["count"] >= len(recorded)
    disp_sum = sum({s["name"]: s for s in t["spans"]}["dispatch"]
                   ["duration_s"] for t in recorded)
    assert abs(disp_sum - total) < 1e-8 * len(queries)


def _segmented(rng):
    sidx = ShardedVectorIndex.build_sharded(
        rng.normal(size=(16, N_FEAT)).astype(np.float32), device="cpu",
        seal_threshold=4)
    for _ in range(3):
        sidx = sidx.add_documents(rng.normal(size=(4, N_FEAT))
                                  .astype(np.float32))
    return sidx


class _Racing:
    """A served index whose merge lets an add land on its engine between
    the rebuild and the daemon's compare-and-swap."""

    def __init__(self, inner, rows):
        self.inner, self.rows, self.engine = inner, rows, None

    def merge_segments(self, start=0, count=None):
        out = self.inner.merge_segments(start, count)
        self.engine.add_documents(self.rows)
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_a_raced_merge_is_counted_and_marked_discarded():
    rng = np.random.default_rng(3)
    reg = MetricsRegistry()
    racing = _Racing(_segmented(rng),
                     rng.normal(size=(2, N_FEAT)).astype(np.float32))
    eng = BatchedSearchEngine(racing, metrics=reg, group=0,
                              **dict(KW, batch_size=2))
    racing.engine = eng
    try:
        daemon = MaintenanceDaemon(
            [eng], threshold=0.9, metrics=reg,
            merge_policy=TieredMergePolicy(merge_factor=3))
        with _profiling():
            assert daemon.poll_once() == 0
            snap = reg.snapshot()["timeline"]
        assert reg.series("maintenance.merges.discarded") == {"group=0": 1}
        assert daemon.merges == 0
        merges = [s for s in _spans(snap) if s["name"] == "maintenance.merge"]
        assert len(merges) == 1 and merges[0]["group"] == 0
        assert MERGE_OUTCOMES[merges[0]["arg0"]] == "discarded"
        assert MERGE_KINDS[merges[0]["arg1"]] == "merge"
        # the add's own spans: inside the lock, and its seal its child
        adds = [s for s in _spans(snap) if s["name"] == "ingest.add"]
        assert len(adds) == 1 and adds[0]["group"] == 0
        # the fresh index merges on the next sweep; the counter counts on
        # with no profiler
        assert daemon.poll_once() == 1
        assert reg.series("maintenance.merges.discarded") == {"group=0": 1}
        assert reg.series("maintenance.merges") == {"group=0": 1}
    finally:
        eng.close()


def test_an_add_that_seals_records_its_seal_as_a_child():
    rng = np.random.default_rng(4)
    reg = MetricsRegistry()
    eng = BatchedSearchEngine(_segmented(rng), metrics=reg, group=1, **KW)
    try:
        with _profiling():
            eng.add_documents(rng.normal(size=(4, N_FEAT))
                              .astype(np.float32))
            snap = reg.snapshot()["timeline"]
    finally:
        eng.close()
    spans = {s["name"]: s for s in _spans(snap)}
    add, seal = spans["ingest.add"], spans["ingest.seal"]
    assert seal["parent"] == add["span"] and seal["group"] == add["group"]
    assert add["t0_ns"] <= seal["t0_ns"] <= seal["t1_ns"] <= add["t1_ns"]
    hist = reg.snapshot()["histograms"]["engine.ingest.latency_s"]
    assert abs(hist["group=1"]["sum"]
               - (add["t1_ns"] - add["t0_ns"]) * 1e-9) < 1e-8


@pytest.mark.parametrize("engine", list(ENGINES))
def test_flat_and_segmented_close_the_same_phase_spans(index, queries,
                                                       engine):
    rng = np.random.default_rng(6)
    sidx = _segmented(rng).add_documents(
        rng.normal(size=(2, N_FEAT)).astype(np.float32))
    assert sidx.n_segments == 3 and sidx.n_active == 2
    tl = MetricsRegistry().timeline
    got = {}
    for name, idx in (("flat", index), ("segmented", sidx)):
        with tl.sink(batch=1) as sink:
            idx.search(torch.from_numpy(queries[:3]), k=3, page=8,
                       engine=engine)
        got[name] = [(s["name"], s["arg0"], s["arg1"])
                     for s in _spans(tl.snapshot())
                     if s["parent"] == sink.parent]
    assert got["flat"] == [("search.encode", 0, 0), ("search.phase1", 1, 1),
                           ("search.rescore", 0, 0)]
    assert got["segmented"] == [("search.encode", 0, 0),
                                ("search.phase1", 1, 4),
                                ("search.merge", 0, 0),
                                ("search.rescore", 0, 0)]


def test_one_router_pick_span_per_routed_submit(index, queries):
    reg = MetricsRegistry()
    cl = ClusterEngine([index, index], metrics=reg, **KW)
    try:
        with _profiling():
            futs = [cl.submit(q, stream=i % 3)
                    for i, q in enumerate(queries)]
            for f in futs:
                f.result(timeout=WAIT)
            snap = reg.snapshot()["timeline"]
    finally:
        cl.close()
    picks = [s for s in _spans(snap) if s["name"] == "router.pick"]
    assert len(picks) == len(queries)
    assert {s["thread"] for s in picks} == {threading.get_native_id()}
    assert all(s["t1_ns"] >= s["t0_ns"] for s in picks)
    phase1 = [s for s in _spans(snap) if s["name"] == "search.phase1"]
    assert phase1 and {s["group"] for s in phase1} <= {0, 1}


def test_exports_leave_the_timeline_out(index, queries, tmp_path):
    reg = MetricsRegistry()
    path = tmp_path / "history.jsonl"
    exporter = MetricsExporter(reg, path=str(path))
    eng = BatchedSearchEngine(index, metrics=reg, **KW)
    try:
        with _profiling():
            _serve_one_by_one(eng, queries[:4])
            snap = reg.snapshot()
            rec = exporter.collect()
            bundle = diagnostics_bundle(eng, exporter=exporter)
    finally:
        eng.close()
        exporter.stop()
    assert "timeline" in snap
    plain = {k: v for k, v in snap.items() if k != "timeline"}
    assert prometheus_text(snap) == prometheus_text(plain)
    assert set(rec["metrics"]) == set(plain)
    line = json.loads(path.read_text().splitlines()[-1])
    assert set(line["metrics"]) == set(plain)
    assert "timeline" not in bundle["metrics"]
    json.dumps(bundle["metrics"])
    assert "timeline" not in exporter.history()[-1]["metrics"]
