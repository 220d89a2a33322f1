"""The batcher's CUDA graphs (``repro_torch.serve.graphs``): an index
instance's first batch runs eagerly, its second captures the search and
is answered by the first replay, every later batch replays; a new
instance (an add, a swap) captures anew; CPU indexes, the composed
engines and profiled batches stay eager; a capture that raises leaves
the instance eager; a replay files the bookkeeping of its eager batch.

On the CPU the capture backend is :class:`RecordingBackend`, which runs
the captured function where a graph would record it and again at each
replay, writing into the capture's outputs as a graph's replay writes
its static ones.  The tests marked ``cuda`` hold the real graphs'
answers to the eager search's bit for bit on the card and skip without
one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_search_graph.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.cluster.router import ClusterEngine
from repro_torch.core import TrimFilter, VectorIndex
from repro_torch.core.search import ENGINES
from repro_torch.dist.shard_index import ShardedVectorIndex
from repro_torch.kernels.fused_phase1 import ops as fp_ops
from repro_torch.launch.mesh import make_shard_mesh
from repro_torch.obs import cost
from repro_torch.obs.compile_watch import CompileWatch
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.engine import BatchedSearchEngine

N_DOCS, N_FEAT, B = 240, 16, 4
KW = dict(k=5, page=40, trim=TrimFilter(0.05))
COUNTERS = ("captures", "replays", "eager", "failed")
CAPTURED = [n for n, e in ENGINES.items() if e.captured]
EAGER = [n for n, e in ENGINES.items() if not e.captured]


class RecordingBackend:
    """The capture backend on the CPU.  ``calls`` lists "capture" and
    "replay" in order and ``shares`` each capture's pool donor; the
    captures numbered in ``fail`` (from 0; ``True``: all) raise."""

    def __init__(self, fail=()):
        self.fail = fail
        self.calls, self.shares = [], []

    def engages(self, device) -> bool:
        return True

    def capture(self, fn, device, share=None):
        self.calls.append("capture")
        self.shares.append(share)
        if self.fail is True or len(self.shares) - 1 in self.fail:
            raise RuntimeError("capture refused")
        out = fn()
        return (fn, out), out

    def replay(self, graph) -> None:
        self.calls.append("replay")
        fn, out = graph
        with cost.Tape():          # a replay files nothing of its own
            fresh = fn()
        for o, f in zip(out, fresh):
            o.copy_(f)


@pytest.fixture(scope="module")
def vectors():
    return np.random.default_rng(0).normal(
        size=(N_DOCS, N_FEAT)).astype(np.float32)


@pytest.fixture(scope="module")
def index(vectors):
    return VectorIndex.build(vectors, device="cpu")


def _queries(n, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, N_FEAT)).astype(np.float32)


def _engine(index, engine="fused", backend=None, reg=None, **kw):
    """A batcher whose batches fill to ``B`` (the long wait); ``backend``
    replaces the card's capture backend before the first batch."""
    eng = BatchedSearchEngine(
        index, batch_size=B, max_wait_s=30.0, engine=engine,
        metrics=reg if reg is not None else MetricsRegistry(),
        **{**KW, **kw})
    if backend is not None:
        eng._graphs.backend = backend
    return eng


def _batch(eng, qs, profile=False):
    """One full batch (the long wait fills it) -> (ids, scores) arrays."""
    futs = [eng.submit(q, profile=profile) for q in qs]
    got = [f.result(timeout=120) for f in futs]
    return (np.stack([g[0] for g in got]), np.stack([g[1] for g in got]))


def _direct(index, qs, engine="fused", **kw):
    ids, scores = index.search(torch.from_numpy(qs), engine=engine,
                               **{**KW, **kw})
    return ids.cpu().numpy(), scores.cpu().numpy()


def _counts(reg, **labels):
    return {c: reg.value(f"engine.graph.{c}", **labels) for c in COUNTERS}


def _timed_captures(reg, label=""):
    """Captures ``engine.graph.capture.latency_s`` timed."""
    h = reg.snapshot()["histograms"].get("engine.graph.capture.latency_s",
                                         {})
    return h[label]["count"] if label in h else 0


def _assert_same(got, want):
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


# ------------------------------------------------------------ the cycle
@pytest.mark.parametrize("engine", CAPTURED)
def test_second_batch_captures_later_batches_replay(index, engine):
    backend, reg = RecordingBackend(), MetricsRegistry()
    eng = _engine(index, engine, backend, reg)
    try:
        for i in range(5):
            qs = _queries(B, seed=10 + i)
            _assert_same(_batch(eng, qs), _direct(index, qs, engine))
    finally:
        eng.close()
    assert backend.calls == ["capture"] + ["replay"] * 4
    assert _counts(reg) == {"captures": 1, "replays": 3, "eager": 1,
                            "failed": 0}


def test_new_capture_after_swap_and_add(vectors):
    """An add and a swap each give the engine a new instance: its first
    batch is eager and its second captures, in the pool of the graph
    before; the added document is found by the replay."""
    mesh = make_shard_mesh(2, 1, device="cpu")
    first = ShardedVectorIndex.build_sharded(vectors[:200], mesh=mesh)
    other = ShardedVectorIndex.build_sharded(vectors[40:], mesh=mesh)
    backend, reg = RecordingBackend(), MetricsRegistry()
    eng = _engine(first, "fused_int8", backend, reg)
    try:
        def three():
            for i in range(3):
                qs = _queries(B, seed=20 + i)
                _assert_same(_batch(eng, qs),
                             _direct(eng.index, qs, "fused_int8"))

        three()
        new_id = eng.add_documents(vectors[200:210])
        three()
        qs = vectors[200:200 + B] + 1e-3
        got = _batch(eng, qs)
        _assert_same(got, _direct(eng.index, qs, "fused_int8"))
        assert list(got[0][:, 0]) == list(range(new_id, new_id + B))
        assert eng.swap_index(other, expected=eng.index)
        three()
    finally:
        eng.close()
    assert backend.calls == (["capture"] + ["replay"] * 2
                             + ["capture"] + ["replay"] * 3
                             + ["capture"] + ["replay"] * 2)
    assert backend.shares[0] is None
    assert backend.shares[1] is not None and backend.shares[2] is not None
    assert backend.shares[1] is not backend.shares[2]
    assert _counts(reg) == {"captures": 3, "replays": 4, "eager": 3,
                            "failed": 0}
    assert _timed_captures(reg) == 3


# ------------------------------------------------------- staying eager
@pytest.mark.parametrize("case", ["cpu_index"] + EAGER)
def test_eager_where_graphs_do_not_engage(index, case):
    """A CPU index under the card's backend, and every engine the table
    does not capture under any backend, run every batch eagerly."""
    backend = None if case == "cpu_index" else RecordingBackend()
    engine = "fused" if case == "cpu_index" else case
    reg = MetricsRegistry()
    eng = _engine(index, engine, backend, reg)
    try:
        for i in range(4):
            qs = _queries(B, seed=30 + i)
            _assert_same(_batch(eng, qs), _direct(index, qs, engine))
    finally:
        eng.close()
    assert backend is None or backend.calls == []
    assert _counts(reg) == {"captures": 0, "replays": 0, "eager": 4,
                            "failed": 0}


def test_profiled_batches_run_eagerly(index):
    """A batch with a profiled request runs eagerly and leaves the
    instance's graph as it was."""
    backend, reg = RecordingBackend(), MetricsRegistry()
    eng = _engine(index, "fused", backend, reg)
    try:
        for i, profiled in enumerate([True, False, False, True, False]):
            qs = _queries(B, seed=40 + i)
            want = _direct(index, qs)
            futs = [eng.submit(q, profile=profiled) for q in qs]
            got = [f.result(timeout=120) for f in futs]
            assert all(len(g) == (3 if profiled else 2) for g in got)
            _assert_same((np.stack([g[0] for g in got]),
                          np.stack([g[1] for g in got])), want)
    finally:
        eng.close()
    assert backend.calls == ["capture", "replay", "replay"]
    assert _counts(reg) == {"captures": 1, "replays": 1, "eager": 3,
                            "failed": 0}


def test_failed_capture_leaves_the_instance_eager(index, vectors):
    backend, reg = RecordingBackend(fail=True), MetricsRegistry()
    eng = _engine(index, "fused", backend, reg)
    other = VectorIndex.build(vectors[::-1].copy(), device="cpu")
    try:
        for i in range(4):
            qs = _queries(B, seed=50 + i)
            _assert_same(_batch(eng, qs), _direct(index, qs))
        assert eng.swap_index(other)
        for i in range(2):
            qs = _queries(B, seed=60 + i)
            _assert_same(_batch(eng, qs), _direct(other, qs))
    finally:
        eng.close()
    assert backend.calls == ["capture", "capture"]
    assert backend.shares == [None, None]
    assert eng._graphs.last_failure == "RuntimeError('capture refused')"
    assert _counts(reg) == {"captures": 0, "replays": 0, "eager": 6,
                            "failed": 2}
    assert _timed_captures(reg) == 0


def test_capture_after_a_failed_one_takes_a_new_pool(index, vectors):
    """A capture that failed may leave its pool recording: the next
    instance's capture shares no pool with it."""
    backend, reg = RecordingBackend(fail={1}), MetricsRegistry()
    eng = _engine(index, "fused", backend, reg)
    others = [VectorIndex.build(vectors[s:], device="cpu") for s in (1, 2)]
    try:
        for n, idx in enumerate([index] + others):
            if n:
                assert eng.swap_index(idx)
            for i in range(3):
                qs = _queries(B, seed=65 + 3 * n + i)
                _assert_same(_batch(eng, qs), _direct(idx, qs))
    finally:
        eng.close()
    assert backend.calls == ["capture", "replay", "replay", "capture",
                             "capture", "replay", "replay"]
    assert backend.shares[0] is None and backend.shares[1] is not None
    assert backend.shares[2] is None
    assert _counts(reg) == {"captures": 2, "replays": 2, "eager": 5,
                            "failed": 1}


# -------------------------------------------------------- bookkeeping
_BUMPS = []


class _Counting:
    """A served index whose search counts two launches through
    ``cost.count_launches``, as a kernel wrapper on the card does."""

    def __init__(self, inner):
        self.inner = inner

    def search(self, queries, **kwargs):
        cost.count_launches(_BUMPS.append, 2)
        return self.inner.search(queries, **kwargs)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_replay_files_the_eager_batch_bookkeeping(index):
    """Launch counts and cost rows grow by the same amount for each
    batch, eager, captured or replayed."""
    _BUMPS.clear()
    backend, reg = RecordingBackend(), MetricsRegistry()
    watch = CompileWatch(reg)
    eng = _engine(_Counting(index), "fused", backend, reg,
                  compile_watch=watch)
    per_batch = None
    try:
        for n in range(1, 5):
            _batch(eng, _queries(B, seed=70 + n))
            rows = {(r["region"], tuple(r["sig"]), r["program"]):
                    r["launches"] for r in watch.costs.rows()}
            if per_batch is None:
                per_batch = rows
                assert rows and _BUMPS == [2]
            assert rows == {key: n * v for key, v in per_batch.items()}
            assert sum(_BUMPS) == 2 * n
    finally:
        eng.close()
    assert _counts(reg) == {"captures": 1, "replays": 2, "eager": 1,
                            "failed": 0}


def test_tape_holds_then_files_rows_and_launches():
    watch = CompileWatch(MetricsRegistry())
    counted = []
    work = cost.Work(10.0, 20)
    with cost.Tape() as tape:
        with watch.region("r", sig=(1,)):
            cost.record_kernel("k", work)
            cost.count_launches(counted.append, 2)
    assert watch.costs.rows() == [] and counted == []
    tape.replay()
    tape.replay()
    assert [r["launches"] for r in watch.costs.rows()] == [2]
    assert watch.costs.rows()[0]["region"] == "r"
    assert counted == [2, 2]
    cost.count_launches(counted.append, 2)     # no tape: counted now
    assert counted == [2, 2, 2]


def test_replay_spans_and_no_capture_under_a_profiler(index, vectors):
    """While a profiler session records, a replayed batch's
    ``search.launch`` has one ``search.replay`` child (beside the phases
    this backend's replay runs eagerly, which a graph's does not), an
    eager batch's has the phases alone, and a new instance's capture
    waits for the session's end (whose device synchronise CUDA forbids
    during a capture)."""
    backend, reg = RecordingBackend(), MetricsRegistry()
    eng = _engine(index, "fused", backend, reg)
    other = VectorIndex.build(vectors[::-1].copy(), device="cpu")
    try:
        for i in range(2):                  # eager, capture
            _batch(eng, _queries(B, seed=80 + i))
        with profile(activities=[ProfilerActivity.CPU]):
            _batch(eng, _queries(B, seed=82))           # replay
            assert eng.swap_index(other)
            for i in range(2):                          # eager, eager
                qs = _queries(B, seed=83 + i)
                _assert_same(_batch(eng, qs), _direct(other, qs))
        qs = _queries(B, seed=85)                       # capture
        _assert_same(_batch(eng, qs), _direct(other, qs))
    finally:
        eng.close()
    assert backend.calls == ["capture", "replay", "replay", "capture",
                             "replay"]
    assert _counts(reg) == {"captures": 2, "replays": 1, "eager": 3,
                            "failed": 0}
    tl = reg.snapshot()["timeline"]
    sp, names = tl["spans"], np.asarray(tl["names"])
    launch = sp["span"][names[sp["name"]] == "search.launch"]
    assert launch.size == 3
    kids = [sorted(names[sp["name"][sp["parent"] == p]]) for p in launch]
    assert kids[0].count("search.replay") == 1
    for k in kids[1:]:
        assert k == ["search.encode", "search.phase1", "search.rescore"]


def test_failpoint_raises_under_replay(vectors):
    """A group poisoned after its batches replay still fails (the
    router's failpoint is entered around each replay), and serves by
    replay again once healed."""
    sharded = ShardedVectorIndex.build_sharded(
        vectors, mesh=make_shard_mesh(2, 2, device="cpu"))
    reg = MetricsRegistry()
    cl = ClusterEngine(sharded, batch_size=B, max_wait_s=30.0,
                       engine="fused_int8", metrics=reg, **KW)
    backend = RecordingBackend()
    b = cl.batchers[0]
    b._graphs.backend = backend
    try:
        for i in range(3):
            qs = _queries(B, seed=90 + i)
            _assert_same(_batch(b, qs), _direct(b.index, qs, "fused_int8"))
        cl.inject_failure(0)
        with pytest.raises(RuntimeError, match="injected failure"):
            _batch(b, _queries(B, seed=95))
        cl.heal(0)
        qs = _queries(B, seed=96)
        _assert_same(_batch(b, qs), _direct(b.index, qs, "fused_int8"))
    finally:
        cl.close()
    assert backend.calls == ["capture", "replay", "replay", "replay"]
    assert _counts(reg, group=0) == {"captures": 1, "replays": 1 + 1,
                                     "eager": 1, "failed": 0}


# ------------------------------------------------------------- the card
@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_vectors(n, n_feat=64, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, n_feat)).astype(np.float32)


def _card_queries(n, n_feat=64, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, n_feat)).astype(np.float32)


@pytest.mark.cuda
def test_card_vector_index_replays_equal_eager(card):
    index = VectorIndex.build(_card_vectors(50_000), device=card)
    reg = MetricsRegistry()
    fp_ops.launches = 0
    eng = BatchedSearchEngine(index, batch_size=8, max_wait_s=30.0,
                              engine="fused", metrics=reg, k=10, page=320,
                              trim=TrimFilter(0.05))
    per_batch = []
    try:
        for i in range(6):
            qs = _card_queries(8, seed=100 + i)
            before = fp_ops.launches
            got = _batch(eng, qs)
            per_batch.append(fp_ops.launches - before)
            _assert_same(got, _direct(index, qs, "fused", k=10, page=320))
    finally:
        eng.close()
    assert _counts(reg) == {"captures": 1, "replays": 4, "eager": 1,
                            "failed": 0}
    assert per_batch == [per_batch[0]] * 6 and per_batch[0] > 0


def _card_cluster(vectors, card, reg):
    sharded = ShardedVectorIndex.build_sharded(
        vectors, mesh=make_shard_mesh(4, 2, device=card))
    return ClusterEngine(sharded, batch_size=8, max_wait_s=30.0, k=10,
                         page=320, trim=TrimFilter(0.05), merge="gather",
                         engine="fused_int8", metrics=reg)


def _three(b, seed, engine="fused_int8"):
    """Three batches on batcher ``b`` (on a new instance: eager, capture,
    replay), each answer held to the eager search's -> the int8 kernel
    launches each batch counted."""
    counted = []
    for i in range(3):
        qs = _card_queries(8, seed=seed + i)
        before = fp_ops.quant_launches
        got = _batch(b, qs)
        counted.append(fp_ops.quant_launches - before)
        _assert_same(got, _direct(b.index, qs, engine, k=10, page=320))
    return counted


@pytest.mark.cuda
def test_card_cluster_4x2_int8_replays_equal_eager(card):
    reg = MetricsRegistry()
    cl = _card_cluster(_card_vectors(80_000), card, reg)
    try:
        for g, b in enumerate(cl.batchers):
            # 4 shards, one int8 call each, two kernels a call
            assert _three(b, 200 + 10 * g) == [8, 8, 8]
            assert _three(b, 300 + 10 * g) == [8, 8, 8]   # replays only
        cl.inject_failure(0)
        with pytest.raises(RuntimeError, match="injected failure"):
            _batch(cl.batchers[0], _card_queries(8, seed=400))
        cl.heal(0)
        _three(cl.batchers[0], 410)               # replays again
    finally:
        cl.close()
    for g in range(2):
        c = _counts(reg, group=g)
        assert c["captures"] == 1 and c["failed"] == 0
        assert c["replays"] >= 4


@pytest.mark.cuda
def test_card_cluster_after_add_and_merge(card):
    """After an add the new documents are found by the replays; after a
    merge's swap the merged instance captures anew; replies equal the
    eager search's bit for bit throughout."""
    vectors = _card_vectors(80_000)
    added = _card_vectors(700, seed=7)
    reg = MetricsRegistry()
    cl = _card_cluster(vectors, card, reg)
    try:
        for g, b in enumerate(cl.batchers):
            _three(b, 500 + 10 * g)
        first = cl.add_documents(added[:300])       # seals a segment
        cl.add_documents(added[300:600])            # and another
        cl.add_documents(added[600:])               # an active buffer
        for g, b in enumerate(cl.batchers):
            _three(b, 600 + 10 * g)
            qs = added[:8] + 1e-3
            got = _batch(b, qs)
            _assert_same(got, _direct(b.index, qs, "fused_int8", k=10,
                                      page=320))
            assert list(got[0][:, 0]) == list(range(first, first + 8))
        for g, b in enumerate(cl.batchers):
            snap = b.index
            assert snap.n_segments >= 2
            assert b.swap_index(snap.merge_segments(), expected=snap)
            _three(b, 700 + 10 * g)
    finally:
        cl.close()
    for g in range(2):
        c = _counts(reg, group=g)
        assert c["captures"] == 3 and c["failed"] == 0


@pytest.mark.cuda
def test_card_cluster_serves_through_live_ingest(card):
    """Routed queries between bulk adds while the merge daemon runs: each
    group captures anew as its index changes, one batcher's captures
    overlap the other's replays and its old graphs' release, and no batch
    or capture fails; profiler sessions that start and stop meanwhile (a
    stop synchronises the device) end cleanly."""
    import contextlib

    reg = MetricsRegistry()
    sharded = ShardedVectorIndex.build_sharded(
        _card_vectors(80_000), mesh=make_shard_mesh(4, 2, device=card))
    cl = ClusterEngine(sharded, batch_size=8, max_wait_s=0.002, k=10,
                       page=320, trim=TrimFilter(0.05), merge="gather",
                       engine="fused_int8", auto_compact=0.2, metrics=reg)
    added = _card_vectors(64 * 12, seed=9)
    qs = _card_queries(64, seed=11)
    try:
        for j in range(12):
            cl.add_documents(added[64 * j:64 * (j + 1)])
            for r in range(3):
                with (profile(activities=[ProfilerActivity.CUDA])
                      if j % 4 == 3 and r == 0 else contextlib.nullcontext()):
                    futs = [cl.submit(q, stream=i % 16)
                            for i, q in enumerate(qs)]
                    for f in futs:
                        f.result(timeout=120)
        for g, b in enumerate(cl.batchers):
            _three(b, 800 + 10 * g)
    finally:
        cl.close()
    assert reg.value("cluster.requests.failed") == 0
    for g in range(2):
        c = _counts(reg, group=g)
        assert c["failed"] == 0 and c["captures"] >= 6, (g, c)
