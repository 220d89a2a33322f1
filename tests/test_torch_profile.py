"""repro_torch's observability plane through BatchedSearchEngine,
VectorIndex and ShardedVectorIndex, on the CPU.

* **the reference's engine, side by side** -- over one flat JAX
  ``VectorIndex`` carried across with ``interop``, the JAX engine and the
  port's serve the same request sequence (profiled and plain requests, a
  failing one, a swap) with the full plane on, for all six engines:
  ``stats()`` has the same keys at every level (the cost rollup,
  ``compile.cost``, to its top: its rows are XLA's cost model there and
  analytic here), request, ingest and ``kernel_path`` counters and
  histogram counts
  are equal, and the profile trees have equal node names and equal
  non-timing attributes;
* **bit-parity with everything on** -- metrics + tracer + slow log +
  build watch + ``profile=True`` give the bare engine's ids and scores
  bit for bit, for all six engines, on a flat index and on a
  ``ShardedVectorIndex`` with a sealed generation, an active buffer and
  tombstones (the history of the JAX suite's ``sidx`` fixture), and so
  with a ``torch.profiler`` session recording, while the timeline writes
  each batch's phase spans;
* **trees reconcile** -- ``queue_wait`` + ``batch_form`` + ``dispatch``
  tile the root (float addition error only), and the segmented
  ``phase1`` node's ``base`` / ``gen{i}`` / ``active`` candidate counts
  sum to its own;
* **totals are exact** under concurrent submitters.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core import VectorIndex as JVectorIndex
from repro.obs import CompileWatch as JCompileWatch
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import SlowLog as JSlowLog
from repro.obs import Tracer as JTracer
from repro.serve.engine import BatchedSearchEngine as JEngine
from repro_torch import interop
from repro_torch.core import RoundingEncoder
from repro_torch.dist import ShardedVectorIndex
from repro_torch.obs import (CompileWatch, MetricsRegistry, ProfileNode,
                             SlowLog, Tracer, format_profile_tree,
                             format_segments_line, format_stats_line,
                             prometheus_text)
from repro_torch.serve.engine import BatchedSearchEngine

N_DOCS, N_FEAT = 60, 16
ALL_ENGINES = ("postings", "codes", "onehot", "codes_pallas", "fused",
               "fused_int8")
KW = dict(batch_size=4, k=5, page=N_DOCS, trim=None)


@pytest.fixture(scope="module")
def jidx():
    return JVectorIndex.build(np.random.default_rng(2).normal(
        size=(N_DOCS, N_FEAT)).astype(np.float32))


@pytest.fixture(scope="module")
def index(jidx):
    return interop.index_from_numpy(
        np.asarray(jidx.vectors), np.asarray(jidx.codes),
        np.asarray(jidx.postings.post_docs),
        np.asarray(jidx.postings.post_codes), RoundingEncoder(2),
        device="cpu")


@pytest.fixture(scope="module")
def sidx():
    """The JAX suite's ``sidx`` history: 24 rows appended past a seal
    threshold of 16 (one sealed generation of 24), then a tombstone in
    each of the base and the generation."""
    rng = np.random.default_rng(0)
    idx = ShardedVectorIndex.build_sharded(
        rng.normal(size=(N_DOCS, N_FEAT)).astype(np.float32),
        seal_threshold=16, device="cpu")
    idx = idx.add_documents(rng.normal(size=(24, N_FEAT)).astype(np.float32))
    return idx.delete(np.array([3, N_DOCS + 2]))


@pytest.fixture()
def queries():
    return np.random.default_rng(1).normal(
        size=(6, N_FEAT)).astype(np.float32)


def _plane(cls_reg, cls_tr, cls_slog, cls_watch, engine_cls, index,
           engine, **kw):
    reg = cls_reg()
    eng = engine_cls(index, engine=engine, metrics=reg,
                     tracer=cls_tr(sample=0.5),
                     slowlog=cls_slog(threshold_s=0.0, metrics=reg),
                     compile_watch=cls_watch(metrics=reg), **{**KW, **kw})
    return eng, reg


def _full(index, engine, **kw):
    return _plane(MetricsRegistry, Tracer, SlowLog, CompileWatch,
                  BatchedSearchEngine, index, engine, **kw)


def _own(reg):
    """A test's own registry and build watch (the process defaults are
    shared by every test of a worker)."""
    return {"metrics": reg, "compile_watch": CompileWatch(metrics=reg)}


def _bare(index, engine, **kw):
    return BatchedSearchEngine(index, engine=engine,
                               **_own(MetricsRegistry(enabled=False)),
                               **{**KW, **kw})


def _shape(tree):
    """A profile tree without its timings: names, attributes, children."""
    return {"name": tree["name"], "attrs": tree["attrs"],
            "children": [_shape(c) for c in tree["children"]]}


def _keys(d, path=""):
    """Every key path of a stats dict; maps keyed by data (functions,
    engines) count as leaves, and so does ``compile.cost``, whose rows
    are XLA's cost model in the JAX package and analytic here."""
    out = set()
    for k, v in d.items():
        out.add(f"{path}{k}")
        if (isinstance(v, dict) and k not in ("by_function", "kernel_path")
                and f"{path}{k}" != "compile.cost"):
            out |= _keys(v, f"{path}{k}.")
    return out


def _assert_tiles(tree, tol=1e-9):
    kids = {c["name"]: c for c in tree["children"]}
    assert list(kids) == ["queue_wait", "batch_form", "dispatch"]
    tiled = sum(c["duration_s"] for c in kids.values())
    assert abs(tree["duration_s"] - tiled) < tol
    assert all(c["duration_s"] >= 0.0 for c in kids.values())
    return kids["dispatch"]


def _serve(eng, queries):
    """The side-by-side request sequence: plain and profiled requests,
    one that fails (a query of the wrong width), and a swap to the same
    index -> the profile trees."""
    trees = []
    try:
        for i, q in enumerate(queries):
            if i % 2:
                trees.append(eng.search(q, timeout=120, profile=True)[2])
            else:
                eng.search(q, timeout=120)
        with pytest.raises(Exception):
            eng.search(np.ones(N_FEAT + 3, np.float32), timeout=120)
        assert eng.swap_index(eng.index, expected=eng.index)
    finally:
        eng.close()
    return trees


# ------------------------------------------------------- flat VectorIndex
@pytest.mark.parametrize("engine", ALL_ENGINES)
def test_vector_index_profile_matches_reference(jidx, index, queries,
                                                engine):
    """encode / phase1 / rescore with the reference's attributes, and the
    bare answers bit for bit."""
    from repro.obs import ProfileNode as JProfileNode

    prof, jprof = ProfileNode("q"), JProfileNode("q")
    ids, scores = index.search(torch.from_numpy(queries), k=5, page=N_DOCS,
                               engine=engine, profile=prof)
    bare_ids, bare_scores = index.search(torch.from_numpy(queries), k=5,
                                         page=N_DOCS, engine=engine)
    assert torch.equal(ids, bare_ids) and torch.equal(scores, bare_scores)
    jidx.search(queries, k=5, page=N_DOCS, engine=engine, profile=jprof)
    assert _shape(prof.to_dict()) == _shape(jprof.to_dict())
    assert [c.name for c in prof.children] == ["encode", "phase1",
                                                "rescore"]
    phase1 = prof.children[1]
    assert phase1.attrs["kernel"] == (
        engine if engine in ("fused", "fused_int8") else "composed")
    assert phase1.attrs["candidates"] == len(queries) * N_DOCS
    assert all(c.duration_s >= 0.0 for c in prof.children)


@pytest.mark.parametrize("engine", ALL_ENGINES)
def test_engine_matches_reference_engine(jidx, index, queries, engine):
    mine, reg = _full(index, engine)
    ref, jreg = _plane(JMetricsRegistry, JTracer, JSlowLog, JCompileWatch,
                       JEngine, jidx, engine)
    trees = _serve(mine, queries)
    jtrees = _serve(ref, queries)
    st, jst = mine.stats(), ref.stats()
    assert _keys(st) == _keys(jst)
    n = len(queries) + 1
    assert st["requests"] == jst["requests"] == {
        "submitted": n, "completed": n - 1, "failed": 1}
    assert st["ingest"] == jst["ingest"] == {
        "added_docs": 0, "delete_ops": 0, "swaps": 1}
    assert st["kernel_path"] == jst["kernel_path"] == {engine: n - 1}
    for name in ("batches", "queue_wait_s", "dispatch_latency_s"):
        assert st[name]["count"] == jst[name]["count"] == n, name
    assert st["batches"] == jst["batches"]          # occupancy 1/4 each
    assert st["index"] == jst["index"]
    assert st["slowlog"] == jst["slowlog"]
    assert st["slowlog"]["captured"] == st["slowlog"]["seen"] == n
    assert st["slowlog"]["errors"] == 1
    assert mine.tracer.stats() == ref.tracer.stats()
    assert [_shape(t) for t in trees] == [_shape(t) for t in jtrees]
    assert st["compile"]["compiles_steady_state"] == 0
    for name in ("engine.requests.completed", "engine.kernel_path",
                 "engine.swaps", "slowlog.captured"):
        assert reg.series(name) == jreg.series(name), name


# ------------------------------------------- instrumented == bare, flat
@pytest.mark.parametrize("engine", ALL_ENGINES)
def test_full_plane_bit_parity_flat(index, queries, engine):
    _parity_flat(index, queries, engine)


@pytest.mark.parametrize("engine", ALL_ENGINES)
def test_full_plane_bit_parity_flat_profiler_recording(index, queries,
                                                      engine):
    """The same, while a ``torch.profiler`` session records: the
    timeline's spans are written and the answers keep their bits."""
    with _profiling():
        reg = _parity_flat(index, queries, engine)
    _assert_phase_spans(reg, ["search.encode", "search.phase1",
                              "search.rescore"], len(queries))


def _profiling():
    return profile(activities=[ProfilerActivity.CPU])


def _assert_phase_spans(reg, phases, n_batches):
    """The timeline of ``n_batches`` one-query batches: each launch's
    children are ``phases``, in order."""
    tl = reg.snapshot()["timeline"]
    names = [tl["names"][i] for i in tl["spans"]["name"]]
    launches = [s for s, n in zip(tl["spans"]["span"], names)
                if n == "search.launch"]
    assert len(launches) == n_batches
    for sid in launches:
        kids = [n for n, p in zip(names, tl["spans"]["parent"]) if p == sid]
        assert kids == phases


def _parity_flat(index, queries, engine):
    bare = _bare(index, engine)
    inst, reg = _full(index, engine)
    try:
        for q in queries:
            bi, bs = bare.search(q, timeout=60)
            ii, iscore, tree = inst.search(q, timeout=60, profile=True)
            assert np.array_equal(bi, ii), engine
            assert np.array_equal(bs, iscore), engine
            disp = _assert_tiles(tree)
            assert disp["attrs"] == {"batch_size": 1, "engine": engine,
                                     "k": 5, "page": N_DOCS}
            assert [c["name"] for c in disp["children"]] == [
                "encode", "phase1", "rescore"]
    finally:
        bare.close()
        inst.close()
    n = len(queries)
    assert reg.value("engine.requests.completed") == n
    assert reg.value("engine.kernel_path", engine=engine) == n
    assert reg.value("slowlog.captured") == reg.value("slowlog.seen") == n
    return reg


# -------------------------------------- instrumented == bare, segmented
@pytest.mark.parametrize("engine", ALL_ENGINES)
def test_full_plane_bit_parity_segmented(sidx, queries, engine):
    _parity_segmented(sidx, queries, engine)


@pytest.mark.parametrize("engine", ALL_ENGINES)
def test_full_plane_bit_parity_segmented_profiler_recording(sidx, queries,
                                                           engine):
    with _profiling():
        reg = _parity_segmented(sidx, queries, engine)
    _assert_phase_spans(reg, ["search.encode", "search.phase1",
                              "search.merge", "search.rescore"],
                        len(queries))


def _parity_segmented(sidx, queries, engine):
    assert sidx.n_segments == 1 and sidx.n_active == 0
    bare = _bare(sidx, engine)
    inst, reg = _full(sidx, engine)
    try:
        for q in queries:
            bi, bs = bare.search(q, timeout=60)
            ii, iscore, tree = inst.search(q, timeout=60, profile=True)
            assert np.array_equal(bi, ii), engine
            assert np.array_equal(bs, iscore), engine
            disp = _assert_tiles(tree)
            kids = {c["name"]: c for c in disp["children"]}
            assert list(kids) == ["encode", "phase1", "merge_select",
                                  "rescore"]
            assert kids["encode"]["attrs"] == {"n_queries": 4, "groups": 1}
            assert kids["merge_select"]["attrs"] == {"k": 5,
                                                     "generations": 1}
            phase1 = kids["phase1"]
            assert phase1["attrs"]["kernel"] == (
                engine if engine in ("fused", "fused_int8") else "composed")
            assert phase1["attrs"]["page_loc"] == N_DOCS
            assert phase1["attrs"]["merge"] == "gather"
            gens = {c["name"]: c["attrs"] for c in phase1["children"]}
            assert list(gens) == ["group0", "base", "gen0"]
            assert gens["group0"] == {"n_queries": 4}
            assert gens["base"]["rows"] == N_DOCS
            assert gens["gen0"]["rows"] == 24
            assert gens["gen0"]["tombstones"] == 1
            assert sum(a["candidates"] for n, a in gens.items()
                       if n != "group0") == phase1["attrs"]["candidates"]
            assert phase1["attrs"]["candidates"] == 4 * N_DOCS
            text = format_profile_tree(tree)
            for name in ("query", "queue_wait", "dispatch", "phase1",
                         "gen0", "rescore"):
                assert name in text
    finally:
        bare.close()
        inst.close()
    st = inst.stats()
    assert st["index"]["n_segments"] == 1
    assert st["index"]["segments"] == [{"rows": 24, "width": 24,
                                        "tombstones": 1,
                                        "deleted_ratio": 1 / 24}]
    assert st["index"]["n_tombstones"] == 2
    assert format_segments_line(st["index"]) == (
        f"segments base={N_DOCS} seg0=24-1 tombstones=2")
    return reg


def test_segmented_candidates_with_an_empty_generation(sidx, queries):
    """A generation no candidate comes from (every row tombstoned) still
    gets its ``gen{i}`` child, with 0 candidates; an active buffer gets
    ``active``."""
    rng = np.random.default_rng(5)
    idx = sidx.add_documents(rng.normal(size=(16, N_FEAT)).astype(
        np.float32))                               # seals: gen1
    assert idx.n_segments == 2 and idx.n_active == 0
    idx = idx.delete(np.arange(sidx.n_ids, idx.n_ids))
    idx = idx.add_documents(rng.normal(size=(2, N_FEAT)).astype(np.float32))
    assert idx.segments[1].tombstones == idx.segments[1].n_rows == 16
    assert idx.n_active == 2
    prof = ProfileNode("q")
    ids, scores = idx.search(torch.from_numpy(queries), k=5, page=5,
                             engine="fused", profile=prof)
    bare = idx.search(torch.from_numpy(queries), k=5, page=5,
                      engine="fused")
    assert torch.equal(ids, bare[0]) and torch.equal(scores, bare[1])
    phase1 = prof.children[1]
    gens = {c.name: c.attrs for c in phase1.children}
    assert list(gens) == ["group0", "base", "gen0", "gen1", "active"]
    assert gens["gen1"] == {"rows": 16, "tombstones": 16, "candidates": 0}
    assert gens["active"]["rows"] == 2 and gens["active"]["tombstones"] == 0
    assert sum(a["candidates"] for n, a in gens.items() if n != "group0") \
        == phase1.attrs["candidates"] == len(queries) * 5


def test_sharded_profile_stream_merge(sidx, queries):
    prof = ProfileNode("q")
    ids, scores = sidx.search(torch.from_numpy(queries), k=5, page=N_DOCS,
                              engine="codes", merge="stream", profile=prof)
    bare = sidx.search(torch.from_numpy(queries), k=5, page=N_DOCS,
                       engine="codes", merge="stream")
    assert torch.equal(ids, bare[0]) and torch.equal(scores, bare[1])
    phase1 = prof.children[1]
    assert phase1.attrs["merge"] == "stream"
    # the stream transport's page is the merged top-k
    assert phase1.attrs["candidates"] == len(queries) * 5


# ------------------------------------------------------- engine behaviour
def test_trace_spans_complete_for_plain_query(index, queries):
    tr = Tracer(sample=1.0)
    eng = BatchedSearchEngine(index, engine="codes", tracer=tr,
                              **_own(MetricsRegistry()), **KW)
    try:
        eng.search(queries[0], timeout=60)
    finally:
        eng.close()
    (trace,) = tr.dump()
    assert trace["t1"] is not None and "error" not in trace["attrs"]
    spans = {s["name"]: s for s in trace["spans"]}
    assert list(spans) == ["queue_wait", "batch_form", "dispatch"]
    assert spans["queue_wait"]["t1"] == spans["batch_form"]["t0"]
    assert spans["batch_form"]["t1"] == spans["dispatch"]["t0"]
    assert spans["dispatch"]["attrs"] == {"group": None, "batch_size": 1,
                                          "batch": 1}


def test_slowlog_tail_capture_beats_head_sampling(index, queries):
    reg = MetricsRegistry()
    tr = Tracer(sample=1.0 / 16)
    slog = SlowLog(threshold_s=0.0, metrics=reg)
    eng = BatchedSearchEngine(index, engine="codes", tracer=tr,
                              slowlog=slog, **_own(reg), **KW)
    try:
        for q in queries:
            eng.search(q, timeout=60)
    finally:
        eng.close()
    assert tr.stats()["sampled"] == 1
    st = slog.stats()
    assert st["seen"] == st["captured"] == len(queries)
    for rec in slog.dump():
        assert rec["slowlog"]["reason"] == "slow"
        assert [c["name"] for c in rec["profile"]["children"]] == [
            "queue_wait", "batch_form", "dispatch"]
    assert reg.value("slowlog.captured") == len(queries)


def test_slowlog_captures_errors_below_threshold(index, queries):
    slog = SlowLog(threshold_s=10.0, metrics=MetricsRegistry())
    reg = MetricsRegistry()
    eng = BatchedSearchEngine(index, engine="codes", **_own(reg),
                              tracer=Tracer(sample=1.0 / 16), slowlog=slog,
                              **{**KW, "batch_size": 2})
    try:
        eng.search(queries[0], timeout=60)
        with pytest.raises(Exception):
            eng.search(np.ones(N_FEAT + 3, np.float32), timeout=60)
    finally:
        eng.close()
    st = slog.stats()
    assert st["seen"] == 2
    assert st["captured"] == st["errors"] == 1
    (rec,) = slog.dump()
    assert rec["slowlog"]["reason"] == "error"
    assert "error" in rec["attrs"]
    (disp,) = [s for s in rec["spans"] if s["name"] == "dispatch"]
    assert "error" in disp["attrs"]
    assert reg.value("engine.requests.failed") == 1
    assert reg.value("engine.requests.completed") == 1


def test_engine_stats_sections_and_prometheus(index, queries):
    eng, reg = _full(index, "fused")
    try:
        for q in queries[:3]:
            eng.search(q, timeout=60)
    finally:
        eng.close()
    st = eng.stats()
    assert st["slowlog"]["seen"] == st["slowlog"]["captured"] == 3
    assert "steady_events" not in st["compile"]
    assert st["kernel_path"] == {"fused": 3}
    assert "p999" in st["dispatch_latency_s"]
    assert st["pending"] == st["queue_depth"] == st["in_flight"] == 0
    line = format_stats_line(st)
    assert "done=3/3" in line and "kernel=fused:3" in line
    series = [ln for ln in prometheus_text(reg.snapshot()).splitlines()
              if ln.startswith("repro_engine_requests_completed_total")]
    assert series == ["repro_engine_requests_completed_total 3"]


def test_kernel_mix_in_stats_and_cat_line(index, queries):
    reg = MetricsRegistry()
    fused = BatchedSearchEngine(index, engine="fused", **_own(reg),
                                **{**KW, "batch_size": 2})
    comp = BatchedSearchEngine(index, engine="codes", **_own(reg),
                               **{**KW, "batch_size": 2})
    try:
        for q in queries[:4]:
            fused.search(q, timeout=60)
        for q in queries[:2]:
            comp.search(q, timeout=60)
    finally:
        fused.close()
        comp.close()
    st = fused.stats()
    assert st["kernel_path"] == {"codes": 2, "fused": 4}
    assert "kernel=codes:2/fused:4" in format_stats_line(st)


def test_group_label_and_ingest_series(sidx, queries):
    """A replica-group engine labels every series ``group=g`` and its
    trees carry the group; hot ingest, delete and swap are counted."""
    reg = MetricsRegistry()
    eng = BatchedSearchEngine(sidx, engine="codes", metrics=reg, group=1,
                              compile_watch=CompileWatch(metrics=reg), **KW)
    try:
        _, _, tree = eng.search(queries[0], timeout=60, profile=True)
        first = eng.add_documents(queries[:3])
        eng.delete([first, 0])
        assert eng.swap_index(eng.index, expected=eng.index)
        eng.search(queries[1], timeout=60)
    finally:
        eng.close()
    assert tree["attrs"]["group"] == 1
    assert _assert_tiles(tree)["attrs"]["group"] == 1
    assert reg.value("engine.requests.completed", group=1) == 2
    assert reg.value("engine.requests.completed") == 0
    st = eng.stats()
    assert st["requests"]["completed"] == 2
    assert st["ingest"] == {"added_docs": 3, "delete_ops": 1, "swaps": 1}
    assert reg.histogram("engine.ingest.latency_s", group=1).count == 2
    assert st["kernel_path"] == {"codes": 2}
    assert st["index"]["n_ids"] == sidx.n_ids + 3
    assert st["index"]["n_tombstones"] == sidx.n_tombstones + 2


class _NoProfile:
    """An index whose ``search`` takes no ``profile`` argument."""

    def __init__(self, inner):
        self.inner = inner

    def search(self, q, k, page, trim, engine):
        return self.inner.search(q, k=k, page=page, trim=trim, engine=engine)


def test_profile_over_an_index_without_profile(index, queries):
    eng = BatchedSearchEngine(_NoProfile(index), engine="codes",
                              **_own(MetricsRegistry()), **KW)
    try:
        ids, scores, tree = eng.search(queries[0], timeout=60, profile=True)
    finally:
        eng.close()
    disp = _assert_tiles(tree)
    assert disp["children"] == []
    want = index.search(torch.from_numpy(queries[:1]), k=5, page=N_DOCS,
                        engine="codes")
    assert np.array_equal(ids, want[0][0].numpy())


def test_concurrent_submitters_exact_totals(index):
    """Counter, histogram and tracer totals are exact under concurrent
    submitters, with profiled requests among them."""
    n_threads, per_thread = 6, 12
    total = n_threads * per_thread
    Q = np.random.default_rng(3).normal(
        size=(total, N_FEAT)).astype(np.float32)
    reg = MetricsRegistry()
    tr = Tracer(capacity=total, sample=1.0)
    slog = SlowLog(threshold_s=0.0, capacity=total, metrics=reg)
    eng = BatchedSearchEngine(index, engine="codes", tracer=tr,
                              slowlog=slog, **_own(reg),
                              **{**KW, "batch_size": 8})
    errors = []

    def drive(t):
        try:
            for i in range(per_thread):
                out = eng.search(Q[t * per_thread + i], timeout=60,
                                 profile=i % 3 == 0)
                assert out[0].shape == (5,)
                if i % 3 == 0:
                    _assert_tiles(out[2])
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors.append(exc)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=drive, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
        eng.close()
    assert not any(th.is_alive() for th in threads)
    assert not errors
    assert reg.value("engine.requests.submitted") == total
    assert reg.value("engine.requests.completed") == total
    assert reg.value("engine.requests.failed") == 0
    assert reg.histogram("engine.queue.wait_s").count == total
    batches = reg.histogram("engine.batch.occupancy").count
    assert reg.value("engine.kernel_path", engine="codes") == batches
    assert reg.histogram("engine.dispatch.latency_s").count == batches
    ts = tr.stats()
    assert ts["seen"] == ts["sampled"] == ts["retained"] == total
    assert all(d["t1"] is not None for d in tr.dump())
    assert slog.stats()["captured"] == slog.stats()["seen"] == total


def test_close_waits_for_trace_finish(index, queries):
    """Trace finish runs in the future's callback on the worker; after
    ``close`` every request's trace is finished."""
    tr = Tracer(sample=1.0)
    eng = BatchedSearchEngine(index, engine="codes", tracer=tr,
                              **_own(MetricsRegistry()),
                              **{**KW, "max_wait_s": 0.05})
    futs = [eng.submit(q) for q in queries]
    eng.close()
    assert all(f.done() for f in futs)
    deadline = time.monotonic() + 5
    while tr.stats()["retained"] < len(queries):
        assert time.monotonic() < deadline
        time.sleep(0.001)
    assert len(tr.dump()) == len(queries)
