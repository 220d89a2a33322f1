"""repro_torch BatchedSearchEngine: batching is invisible and the
lifecycle is safe -- the reference's engine contract, on the port's index
with the ``fused`` engine.

Results come back as numpy and equal a direct ``index.search`` of the same
padded batch bit for bit; a single request equals its unpadded search in
ids, and in scores to rtol 1e-6.
"""

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


def test_defaults_serve_the_fused_engine(index, queries):
    """With no engine named, the engine serves through ``fused``, the one
    engine ported, with the reference's other defaults."""
    eng = BatchedSearchEngine(index)
    try:
        ids, scores = eng.submit(queries[0]).result(timeout=60)
    finally:
        eng.close()
    want_ids, want_s = index.search(torch.from_numpy(queries[:1]), k=10,
                                    page=320, trim=TrimFilter(0.05),
                                    engine="fused")
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


def test_unported_engine_fails_its_batch(index, queries):
    """The engine never quietly swaps engines: an unported one fails the
    batch with NotImplementedError."""
    eng = BatchedSearchEngine(index, batch_size=2, k=5, page=N_DOCS,
                              engine="codes")
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            eng.submit(queries[0]).result(timeout=60)
    finally:
        eng.close()
