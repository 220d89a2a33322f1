"""repro_torch BatchedSearchEngine: batching is invisible and the
lifecycle is safe -- the reference's engine contract, on the port's index
(with the ``fused`` engine unless a test names another).

Results come back as numpy and equal a direct ``index.search`` of the same
padded batch bit for bit; a single request equals its unpadded search in
ids, and in scores to rtol 1e-6.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import TrimFilter, VectorIndex
from repro_torch.serve.engine import BatchedSearchEngine

N_DOCS, N_FEAT = 150, 16
KW = dict(k=5, page=N_DOCS, trim=None, engine="fused")


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(0)
    return VectorIndex.build(
        rng.normal(size=(N_DOCS, N_FEAT)).astype(np.float32), device="cpu")


@pytest.fixture()
def queries():
    return np.random.default_rng(1).normal(
        size=(11, N_FEAT)).astype(np.float32)


def _search(index, q):
    ids, s = index.search(torch.from_numpy(q), **KW)
    return ids.numpy(), s.numpy()


def test_batched_results_match_direct_search(index, queries):
    """Full and partial batches return exactly what index.search returns
    for the same padded batch."""
    eng = BatchedSearchEngine(index, batch_size=4, **KW)
    try:
        futs = [eng.submit(q) for q in queries]   # 11 = 2 full + 1 partial
        got = [f.result(timeout=60) for f in futs]
    finally:
        eng.close()
    gold_ids, gold_s = _search(index, queries)
    for i, (ids, scores) in enumerate(got):
        assert isinstance(ids, np.ndarray) and ids.shape == (5,)
        assert np.array_equal(ids, gold_ids[i]), i
        np.testing.assert_allclose(scores, gold_s[i], rtol=1e-6, atol=0)


def test_defaults_serve_the_codes_engine(index, queries):
    """With no engine named, the engine serves through ``codes`` with the
    reference's other defaults, as the reference's engine does."""
    eng = BatchedSearchEngine(index)
    try:
        ids, scores = eng.submit(queries[0]).result(timeout=60)
    finally:
        eng.close()
    want_ids, want_s = index.search(torch.from_numpy(queries[:1]), k=10,
                                    page=320, trim=TrimFilter(0.05),
                                    engine="codes")
    assert np.array_equal(ids, want_ids[0].numpy())
    np.testing.assert_allclose(scores, want_s[0].numpy(), rtol=1e-6, atol=0)


def test_partial_batch_pad_rows_never_leak(index, queries):
    """batch_size 8, one request: the 7 zero-pad rows must not surface."""
    eng = BatchedSearchEngine(index, batch_size=8, **KW)
    try:
        ids, scores = eng.submit(queries[0]).result(timeout=60)
    finally:
        eng.close()
    padded = np.concatenate([queries[:1], np.zeros((7, N_FEAT), np.float32)])
    batch_ids, batch_s = _search(index, padded)
    gold_ids, gold_s = _search(index, queries[:1])
    assert ids.shape == (5,) and scores.shape == (5,)
    assert np.array_equal(ids, batch_ids[0])
    assert np.array_equal(scores, batch_s[0])
    assert np.array_equal(ids, gold_ids[0])
    np.testing.assert_allclose(scores, gold_s[0], rtol=1e-6)


def test_close_drains_pending_requests(index, queries):
    """Everything queued before close() resolves; close() blocks until then."""
    eng = BatchedSearchEngine(index, batch_size=4, max_wait_s=10.0, **KW)
    futs = [eng.submit(q) for q in queries]       # partial last batch queued
    eng.close()
    for f in futs:
        ids, _ = f.result(timeout=0)              # must already be resolved
        assert ids.shape == (5,)


def test_submit_after_close_raises(index, queries):
    eng = BatchedSearchEngine(index, batch_size=4, **KW)
    eng.close()
    with pytest.raises(RuntimeError, match="engine closed"):
        eng.submit(queries[0])
    with pytest.raises(RuntimeError, match="engine closed"):
        eng.add_documents(queries)


def test_deadline_anchors_to_oldest_request(index, queries):
    """A lone request waits about max_wait_s, not forever and not for a
    full batch."""
    eng = BatchedSearchEngine(index, batch_size=64, max_wait_s=0.05, **KW)
    try:
        t0 = time.monotonic()
        ids, _ = eng.submit(queries[0]).result(timeout=60)
        waited = time.monotonic() - t0
    finally:
        eng.close()
    assert ids.shape == (5,)
    assert 0.05 <= waited < 30


class _FlakyIndex:
    """index.search stand-in that raises on marked batches."""

    def __init__(self, inner):
        self.inner = inner
        self.poison = threading.Event()

    def search(self, queries, **kw):
        if self.poison.is_set():
            raise ValueError("injected search failure")
        return self.inner.search(queries, **kw)


def test_worker_survives_search_exception(index, queries):
    """A raising search fails that batch's futures with the original error
    and the SAME worker keeps serving subsequent batches."""
    flaky = _FlakyIndex(index)
    eng = BatchedSearchEngine(flaky, batch_size=4, **KW)
    try:
        flaky.poison.set()
        bad = [eng.submit(q) for q in queries[:4]]
        for f in bad:
            with pytest.raises(ValueError, match="injected search failure"):
                f.result(timeout=60)
        assert eng._worker.is_alive()
        flaky.poison.clear()
        gold_ids, _ = _search(index, queries[4:8])
        good = [eng.submit(q) for q in queries[4:8]]
        for i, f in enumerate(good):
            ids, _ = f.result(timeout=60)
            assert np.array_equal(ids, gold_ids[i])
    finally:
        eng.close()


def test_cancelled_future_does_not_kill_worker(index, queries):
    eng = BatchedSearchEngine(index, batch_size=4, **KW)
    try:
        with eng._lock:                   # hold the worker off the queue
            futs = [eng.submit(q) for q in queries[:4]]
            assert futs[0].cancel()
        for f in futs[1:]:
            ids, _ = f.result(timeout=60)
            assert ids.shape == (5,)
        assert eng._worker.is_alive()
        ids, _ = eng.submit(queries[4]).result(timeout=60)
        assert ids.shape == (5,)
    finally:
        eng.close()


def test_concurrent_submitters_all_resolve(index):
    rng = np.random.default_rng(2)
    Q = rng.normal(size=(24, N_FEAT)).astype(np.float32)
    gold_ids, _ = _search(index, Q)
    eng = BatchedSearchEngine(index, batch_size=5, **KW)
    results = {}

    def worker(i):
        results[i] = eng.submit(Q[i]).result(timeout=60)

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(Q))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        eng.close()
    assert len(results) == len(Q)
    for i, (ids, _) in results.items():
        assert np.array_equal(ids, gold_ids[i]), i


class _GatedFlakyIndex:
    """Blocks in search until released, then optionally raises."""

    def __init__(self, inner):
        self.inner = inner
        self.entered = threading.Event()
        self.release = threading.Event()
        self.poison = threading.Event()

    def search(self, queries, **kw):
        self.entered.set()
        assert self.release.wait(timeout=60), "gate never released"
        if self.poison.is_set():
            raise ValueError("injected search failure")
        return self.inner.search(queries, **kw)


def test_hot_swap_races_raising_search(index, queries):
    """A hot swap lands while the in-flight batch is mid-raise: only that
    batch fails, and the next batch serves from the swapped index."""
    gated = _GatedFlakyIndex(index)
    eng = BatchedSearchEngine(gated, batch_size=4, **KW)
    try:
        gated.poison.set()
        doomed = [eng.submit(q) for q in queries[:4]]
        assert gated.entered.wait(timeout=60)
        assert eng.swap_index(index, expected=gated)
        gated.release.set()
        for f in doomed:
            with pytest.raises(ValueError, match="injected search failure"):
                f.result(timeout=60)
        assert eng._worker.is_alive()
        gold_ids, _ = _search(index, queries[4:8])
        good = [eng.submit(q) for q in queries[4:8]]
        for i, f in enumerate(good):
            ids, _ = f.result(timeout=60)
            assert np.array_equal(ids, gold_ids[i])
    finally:
        gated.release.set()
        eng.close()


def test_swap_index_cas_semantics(index):
    other = VectorIndex.build(
        np.random.default_rng(3).normal(size=(40, N_FEAT)).astype(np.float32),
        device="cpu")
    eng = BatchedSearchEngine(index, batch_size=2, k=3, page=N_DOCS,
                              engine="fused")
    try:
        assert eng.swap_index(other, expected=index)
        assert eng.index is other
        assert not eng.swap_index(index, expected=index)  # stale snapshot
        assert eng.index is other
        eng.swap_index(index)                             # unconditional
        assert eng.index is index
    finally:
        eng.close()
    with pytest.raises(RuntimeError, match="engine closed"):
        eng.swap_index(other)


def test_pending_tracks_queue_and_inflight(index, queries):
    gated = _GatedFlakyIndex(index)
    eng = BatchedSearchEngine(gated, batch_size=2, **KW)
    try:
        futs = [eng.submit(q) for q in queries[:5]]
        assert gated.entered.wait(timeout=60)
        assert eng.pending >= 3
        gated.release.set()
        for f in futs:
            f.result(timeout=60)
        deadline = time.monotonic() + 60
        while eng.pending and time.monotonic() < deadline:
            time.sleep(0.005)
        assert eng.pending == 0
    finally:
        gated.release.set()
        eng.close()


@pytest.mark.parametrize("op", ["add_documents", "delete"])
def test_plain_index_has_no_ingest(index, queries, op):
    """A plain VectorIndex is immutable: ingest and delete raise TypeError
    and leave the served index alone."""
    eng = BatchedSearchEngine(index, batch_size=2, **KW)
    try:
        arg = queries[:2] if op == "add_documents" else [0, 1]
        with pytest.raises(TypeError, match="VectorIndex"):
            getattr(eng, op)(arg)
        assert eng.index is index
    finally:
        eng.close()


class _RecordingIndex:
    """index.search stand-in that records what each call was given."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []

    def search(self, queries, **kw):
        self.calls.append((queries, kw))
        return self.inner.search(queries, **kw)


@pytest.mark.parametrize("max_postings", [None, 3])
def test_max_postings_reaches_the_index(index, queries, max_postings):
    """``max_postings`` is passed through to ``index.search``, and left
    out when it is None, as in the reference; the capped search answers
    what a direct capped search answers."""
    rec = _RecordingIndex(index)
    eng = BatchedSearchEngine(rec, batch_size=2, k=5, page=40,
                              engine="postings", max_postings=max_postings)
    try:
        ids, _ = eng.submit(queries[0]).result(timeout=60)
    finally:
        eng.close()
    (_, kw), = rec.calls
    assert kw.get("max_postings") == max_postings
    assert ("max_postings" in kw) == (max_postings is not None)
    padded = np.concatenate([queries[:1], np.zeros((1, N_FEAT), np.float32)])
    want, _ = index.search(torch.from_numpy(padded), k=5, page=40,
                           trim=TrimFilter(0.05), engine="postings",
                           max_postings=max_postings)
    assert np.array_equal(ids, want[0].numpy())


def test_batch_reaches_the_index_on_the_cpu(index, queries):
    """The engine hands the padded batch over as a CPU tensor and the
    index puts it on its own device: an index without ``device`` is not
    served on a device the engine guessed."""
    rec = _RecordingIndex(index)
    eng = BatchedSearchEngine(rec, batch_size=4, **KW)
    try:
        eng.submit(queries[0]).result(timeout=60)
    finally:
        eng.close()
    (batch, _), = rec.calls
    assert isinstance(batch, torch.Tensor) and batch.device.type == "cpu"
    assert batch.shape == (4, N_FEAT) and batch.dtype == torch.float32


def test_unknown_engine_fails_only_its_batch(index, queries):
    """A search that raises (here an unknown engine) fails its own batch
    with the index's error, and the worker serves the next batch."""
    eng = BatchedSearchEngine(index, batch_size=2, k=5, page=N_DOCS,
                              engine="nope")
    try:
        with pytest.raises(ValueError, match="unknown engine"):
            eng.submit(queries[0]).result(timeout=60)
        assert eng._worker.is_alive()
        eng.engine = "codes"
        ids, _ = eng.submit(queries[1]).result(timeout=60)
        assert ids.shape == (5,)
    finally:
        eng.close()


# ------------------------------------------- a ShardedVectorIndex behind it
def _sharded(seed=5, n_docs=23, **kw):
    from repro_torch.dist.shard_index import ShardedVectorIndex

    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n_docs, N_FEAT)).astype(np.float32)
    W = rng.normal(size=(9, N_FEAT)).astype(np.float32)
    return ShardedVectorIndex.build_sharded(V, device="cpu", **kw), V, W


def test_batched_engine_hot_ingest_and_delete():
    """add_documents serves the new docs to every later batch and returns
    the first id; delete hides a doc at once; both raise after close."""
    sidx, V, W = _sharded()
    eng = BatchedSearchEngine(sidx, batch_size=2, k=3, page=1_000, trim=None,
                              engine="codes")
    try:
        ids0, _ = eng.search(V[0], timeout=60)
        assert ids0[0] == 0
        assert eng.add_documents(W) == 23
        ids1, s1 = eng.search(W[4], timeout=60)
        assert ids1[0] == 27 and abs(s1[0] - 1) < 1e-5
        eng.delete([27])
        ids2, _ = eng.search(W[4], timeout=60)
        assert 27 not in ids2
        assert eng.index.n_ids == 32 and eng.index.n_tombstones == 1
    finally:
        eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.add_documents(W)
    with pytest.raises(RuntimeError, match="closed"):
        eng.delete([0])


@pytest.mark.parametrize("merge", [None, "gather", "stream"])
@pytest.mark.parametrize("max_postings", [None, 3, "auto"])
def test_merge_and_max_postings_reach_a_sharded_index(merge, max_postings):
    """``merge`` and ``max_postings`` (``"auto"`` included) go to the
    index as the reference's engine passes them, left out when None, and
    the served answer is the direct search's."""
    sidx, V, W = _sharded(seed=6)
    sidx = sidx.add_documents(W)
    rec = _RecordingIndex(sidx)
    eng = BatchedSearchEngine(rec, batch_size=2, k=5, page=16, trim=None,
                              engine="postings", merge=merge,
                              max_postings=max_postings)
    try:
        ids, scores = eng.submit(V[3]).result(timeout=60)
    finally:
        eng.close()
    (_, kw), = rec.calls
    assert kw.get("merge") == merge and ("merge" in kw) == (merge is not None)
    assert kw.get("max_postings") == max_postings
    padded = np.stack([V[3], np.zeros(N_FEAT, np.float32)])
    want_i, want_s = sidx.search(torch.from_numpy(padded), k=5, page=16,
                                 trim=None, engine="postings",
                                 merge=merge or "gather",
                                 max_postings=max_postings)
    assert np.array_equal(ids, want_i[0].numpy())
    assert np.array_equal(scores, want_s[0].numpy())


def test_donate_ingest_skipped_while_the_index_is_served():
    """donate_ingest donates only while no batch is in flight: an ingest
    during a batch copies, though a delete made the current index a new
    object (it still shares the snapshot's active buffer); the next one,
    with nothing in flight, donates; the answers are a copying ingest's."""
    from repro_torch.dist.shard_index import ShardedVectorIndex

    calls = []
    entered, release = threading.Event(), threading.Event()

    class Spy(ShardedVectorIndex):
        def add_documents(self, vectors, *, donate=False):
            calls.append(donate)
            return super().add_documents(vectors, donate=donate)

        def search(self, queries, **kw):
            entered.set()
            assert release.wait(timeout=60), "gate never released"
            return super().search(queries, **kw)

    sidx, V, W = _sharded(seed=7, seal_threshold=None)
    sidx = Spy(**{f.name: getattr(sidx, f.name)
                  for f in dataclasses.fields(sidx)}).add_documents(W[:2])
    calls.clear()
    eng = BatchedSearchEngine(sidx, batch_size=2, k=3, page=100, trim=None,
                              engine="codes", donate_ingest=True)
    try:
        fut = eng.submit(V[0])
        assert entered.wait(timeout=60)
        assert eng._serving is sidx
        eng.delete([1])        # a new index sharing sidx's active buffer
        assert eng.index is not sidx
        assert eng.index.seg_vectors is sidx.seg_vectors
        before = sidx.seg_live.clone()
        eng.add_documents(W[2:4])           # the batch in flight reads it
        assert torch.equal(sidx.seg_live, before)
        release.set()
        fut.result(timeout=60)
        deadline = time.monotonic() + 60
        while eng.pending and time.monotonic() < deadline:
            time.sleep(0.005)
        assert eng._serving is None
        served = eng.index
        eng.add_documents(W[4:6])           # nothing in flight: donated
        assert calls == [False, True]
        assert eng.index.seg_vectors.data_ptr() == \
            served.seg_vectors.data_ptr()
        ids, s = eng.search(W[5], timeout=60)
    finally:
        release.set()
        eng.close()
    assert ids[0] == 23 + 5 and abs(s[0] - 1) < 1e-5
    copied = sidx.delete([1]).add_documents(W[2:4]).add_documents(W[4:6])
    want = copied.search(W[5:6], k=3, page=100, trim=None, engine="codes")
    assert np.array_equal(ids, want[0][0].numpy())


def test_sharded_from_numpy_round_trips_jax_leaves():
    """interop.sharded_from_numpy carries a JAX ShardedVectorIndex's build
    leaves across bit for bit; the port's own leaves, segments and
    counters included, round-trip to the same answers."""
    import jax.numpy as jnp

    from repro.core import encoding as jenc
    from repro.dist.shard_index import ShardedVectorIndex as JSharded
    from repro.launch.mesh import make_shard_mesh
    from repro_torch import interop
    from repro_torch.core import RoundingEncoder

    rng = np.random.default_rng(8)
    V = rng.normal(size=(30, N_FEAT)).astype(np.float32)
    Q = rng.normal(size=(4, N_FEAT)).astype(np.float32)
    names = ("vectors", "codes", "post_docs", "post_codes", "offsets",
             "live")
    jidx = JSharded.build_sharded(jnp.asarray(V), make_shard_mesh(1),
                                  encoder=jenc.RoundingEncoder(2))
    got = interop.sharded_from_numpy(
        *(np.asarray(getattr(jidx, n)) for n in names), RoundingEncoder(2),
        jidx.n_docs, jidx.index_best, seal_threshold=jidx.seal_threshold,
        device="cpu")
    for n in names:
        assert np.array_equal(getattr(got, n).numpy(),
                              np.asarray(getattr(jidx, n))), n
    assert got.n_ids == jidx.n_ids and got.seg_capacity == 0
    assert got.max_df == jidx.max_df

    port = got.add_documents(rng.normal(size=(7, N_FEAT)).astype(np.float32))
    port = port.add_documents(rng.normal(size=(300, N_FEAT))
                              .astype(np.float32)).delete([1, 31, 40])
    port = port.add_documents(rng.normal(size=(3, N_FEAT))
                              .astype(np.float32))
    assert port.n_segments == 1 and port.n_active == 3

    def arr(t):
        return t.numpy()

    back = interop.sharded_from_numpy(
        *(arr(getattr(port, n)) for n in names), RoundingEncoder(2),
        port.n_docs, port.index_best,
        seg_vectors=arr(port.seg_vectors), seg_codes=arr(port.seg_codes),
        seg_gids=arr(port.seg_gids), seg_live=arr(port.seg_live),
        segments=[(arr(s.vectors), arr(s.codes), arr(s.gids), arr(s.live),
                   arr(s.post_docs), arr(s.post_codes), s.n_rows,
                   s.tombstones) for s in port.segments],
        n_appended=port.n_appended, shard_tombstones=port.shard_tombstones,
        seal_threshold=port.seal_threshold, seg_base=port.seg_base,
        active_tombstones=port.active_tombstones, device="cpu")
    assert (back.n_ids, back.n_segments, back.n_active, back.n_tombstones) \
        == (port.n_ids, port.n_segments, port.n_active, port.n_tombstones)
    for engine in ("postings", "fused", "fused_int8"):
        a = port.search(Q, k=6, page=50, engine=engine)
        b = back.search(Q, k=6, page=50, engine=engine)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), engine
    with pytest.raises(ValueError, match="leaves of 2 shards"):
        interop.sharded_from_numpy(
            np.zeros((2, 3, N_FEAT), np.float32), *(np.zeros(1),) * 5,
            RoundingEncoder(2), 6, device="cpu")
