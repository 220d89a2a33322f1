"""repro_torch.cluster -- the control plane (routing, failover, health,
maintenance, restore) held to the JAX package's ``repro.cluster``.

1. Every test of tests/test_cluster.py, ported: routing is invisible (any
   group answers bit for bit as one batcher over the same index, for all
   six engines), failover is transparent, a full outage surfaces the
   error and rolls health back, background compaction hot-swaps under
   traffic, the CAS respects a racing ingest, a failing rebuild is
   quarantined, down groups are skipped, and the data-plane hooks are
   exact.  The 4 x 2 tests run in process on
   ``make_shard_mesh(4, 2, device="cpu")``.
2. The cluster's other pins in the JAX suite (tests/test_store.py,
   tests/test_segments.py, tests/test_obs.py, tests/test_profile.py,
   tests/test_device_obs.py): restore from disk (at 4 x 2 too), canary
   probing and drains, the merge planner and daemon, stats, traces,
   profiles and ``cluster_health``.
3. Cross-package oracles: the same seeded ``HealthMap`` history gives
   equal ledgers, snapshots and counters; ``TieredMergePolicy.select``
   agrees on seeded segment lists; the port's cluster over
   ``interop.index_from_numpy`` groups answers as the reference's
   ``ClusterEngine`` over its flat ``VectorIndex`` groups, through
   routing, failover, drains and an outage, with equal health and
   routing counters.
4. The port's own: a sibling group's tensors are untouched by another
   group's ingest, each group's searches run in its profiler range, and
   the kernels' launch counters count exactly under 8 threads.

Every wait has a timeout of at most 30 s; no result is waited for by
sleeping.
"""

import inspect
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro.cluster import ClusterEngine as JCluster
from repro.cluster import HealthMap as JHealthMap
from repro.cluster import TieredMergePolicy as JPolicy
from repro.core import VectorIndex as JVectorIndex
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro_torch import interop
from repro_torch.cluster import (ClusterEngine, HealthMap, MaintenanceDaemon,
                                 TieredMergePolicy)
from repro_torch.cluster.router import _FailpointIndex
from repro_torch.core import RoundingEncoder
from repro_torch.core.rerank import normalize
from repro_torch.core.search import _SENTINEL
from repro_torch.dist import ShardedVectorIndex
from repro_torch.launch import make_shard_mesh
from repro_torch.obs import (MetricsRegistry, Tracer, format_health_line,
                             format_stats_line)
from repro_torch.serve import BatchedSearchEngine
from repro_torch.store import Store, latest_commit, read_ops, recover

N_DOCS, N_FEAT = 60, 16
ENGINES = ("postings", "codes", "onehot", "codes_pallas", "fused",
           "fused_int8")
WAIT = 30
TOL = 1e-5
LEAVES = ("vectors", "codes", "post_docs", "post_codes", "offsets", "live",
          "seg_vectors", "seg_codes", "seg_gids", "seg_live")
SEG_LEAVES = ("vectors", "codes", "gids", "live", "post_docs", "post_codes")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tensors are tiny: one intra-op thread a worker keeps the
    parallel suite's workers from oversubscribing the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sidx():
    rng = np.random.default_rng(0)
    return ShardedVectorIndex.build_sharded(
        rng.normal(size=(N_DOCS, N_FEAT)).astype(np.float32), device="cpu")


@pytest.fixture()
def queries():
    return np.random.default_rng(1).normal(
        size=(9, N_FEAT)).astype(np.float32)


class _Counting:
    """Group-index wrapper that counts searches (which copy served?)."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = 0

    def search(self, q, **kw):
        self.calls += 1
        return self.inner.search(q, **kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class _Gated:
    """Group index that parks every search until released -- deterministic
    in-flight state for spill/mark_down races."""

    def __init__(self, inner):
        self.inner = inner
        self.entered = threading.Event()
        self.release = threading.Event()

    def search(self, q, **kw):
        self.entered.set()
        assert self.release.wait(timeout=WAIT), "gate never released"
        return self.inner.search(q, **kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _mk_cluster(groups, **kw):
    opts = dict(batch_size=4, k=5, page=N_DOCS, trim=None, engine="codes")
    opts.update(kw)
    return ClusterEngine(groups, **opts)


def _wait_until(cond, what):
    """Poll ``cond`` until it holds, failing after WAIT seconds."""
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _same(a, b, ctx=""):
    assert np.array_equal(a[0], b[0]), ctx
    assert np.array_equal(a[1], b[1]), ctx


# --------------------------------------------------------------- routing
@pytest.mark.parametrize("engine", ENGINES)
def test_any_routing_matches_single_batcher(sidx, queries, engine):
    """Whichever group serves, results == one BatchedSearchEngine over the
    same index, bit for bit (every engine scores each query on its own,
    and the batch is padded to one shape)."""
    cl = _mk_cluster([sidx, sidx, sidx], engine=engine)
    gold = BatchedSearchEngine(sidx, batch_size=4, k=5, page=N_DOCS,
                               trim=None, engine=engine)
    try:
        for i, q in enumerate(queries):
            _same(cl.search(q, stream=i % 3, timeout=WAIT),
                  gold.search(q, timeout=WAIT), (engine, i))
    finally:
        cl.close()
        gold.close()


def test_stream_affinity_pins_one_group(sidx, queries):
    groups = [_Counting(sidx) for _ in range(3)]
    cl = _mk_cluster(groups)
    try:
        for q in queries:
            cl.search(q, stream="user-A", timeout=WAIT)
        assert sum(g.calls > 0 for g in groups) == 1
    finally:
        cl.close()


def test_overflow_spills_to_least_loaded(sidx, queries):
    gated = _Gated(sidx)
    counting = _Counting(sidx)
    cl = _mk_cluster([gated, counting], batch_size=1, spill_factor=2.0)
    try:
        futs = [cl.submit(queries[0], stream="s")]
        assert gated.entered.wait(timeout=WAIT)
        futs += [cl.submit(q, stream="s") for q in queries[1:3]]
        spilled = cl.submit(queries[3], stream="s")
        spilled.result(timeout=WAIT)
        assert counting.calls >= 1
        gated.release.set()
        for f in futs:
            f.result(timeout=WAIT)
        before = counting.calls
        cl.search(queries[4], stream="s", timeout=WAIT)
        assert counting.calls == before
    finally:
        gated.release.set()
        cl.close()


def test_stream_pins_are_lru_capped(sidx, queries):
    """The pin map evicts its coldest stream past ``max_stream_pins``."""
    cl = _mk_cluster([sidx, sidx], max_stream_pins=2)
    try:
        for s in ("a", "b", "c"):
            cl.search(queries[0], stream=s, timeout=WAIT)
        assert list(cl._streams) == ["b", "c"]
        cl.search(queries[0], stream="b", timeout=WAIT)
        assert list(cl._streams) == ["c", "b"]
    finally:
        cl.close()


# -------------------------------------------------------------- failover
def test_mark_down_drains_inflight_and_reroutes(sidx, queries):
    gated = _Gated(sidx)
    counting = _Counting(sidx)
    cl = _mk_cluster([gated, counting], batch_size=1)
    gold = BatchedSearchEngine(sidx, batch_size=1, k=5, page=N_DOCS,
                               trim=None, engine="codes")
    try:
        inflight = [cl.submit(q, stream="s") for q in queries[:3]]
        assert gated.entered.wait(timeout=WAIT)
        assert cl.mark_down(0)
        _same(cl.search(queries[3], stream="s", timeout=WAIT),
              gold.search(queries[3], timeout=WAIT))
        assert counting.calls >= 1
        gated.release.set()
        for i, f in enumerate(inflight):
            _same(f.result(timeout=WAIT), gold.search(queries[i],
                                                      timeout=WAIT), i)
    finally:
        gated.release.set()
        cl.close()
        gold.close()


def test_injected_failure_fails_over_transparently(sidx, queries):
    groups = [_Counting(sidx), _Counting(sidx)]
    cl = _mk_cluster(groups)
    gold = BatchedSearchEngine(sidx, batch_size=4, k=5, page=N_DOCS,
                               trim=None, engine="codes")
    try:
        cl.search(queries[0], stream="s", timeout=WAIT)   # pin to group 0
        assert groups[0].calls == 1
        cl.inject_failure(0)
        _same(cl.search(queries[1], stream="s", timeout=WAIT),
              gold.search(queries[1], timeout=WAIT))
        assert not cl.health.is_up(0)
        assert groups[1].calls >= 1
        cl.heal(0)
        assert cl.mark_up(0)
        before = groups[0].calls
        cl.search(queries[2], stream="s", timeout=WAIT)
        assert groups[0].calls > before
    finally:
        cl.close()
        gold.close()


def test_full_outage_surfaces_error_and_restores_health(sidx, queries):
    cl = _mk_cluster([sidx, sidx])
    try:
        for g in (0, 1):
            cl.inject_failure(g, RuntimeError(f"boom {g}"))
        with pytest.raises(RuntimeError, match="boom"):
            cl.search(queries[0], timeout=WAIT)
        assert cl.health.up_groups() == (0, 1)
        for g in (0, 1):
            cl.heal(g)
        ids, _ = cl.search(queries[0], timeout=WAIT)
        assert ids.shape == (5,)
    finally:
        cl.close()


def test_marked_down_cluster_rejects_new_work(sidx, queries):
    cl = _mk_cluster([sidx, sidx])
    try:
        cl.mark_down(0)
        cl.mark_down(1)
        with pytest.raises(RuntimeError, match="no healthy replica group"):
            cl.search(queries[0], timeout=WAIT)
        assert cl.health.up_groups() == ()
    finally:
        cl.close()


def test_close_closes_every_group_batcher(sidx, queries):
    cl = _mk_cluster([sidx, sidx])
    batchers = cl.batchers
    cl.close()
    with pytest.raises(RuntimeError, match="engine closed"):
        cl.submit(queries[0])
    for b in batchers:
        with pytest.raises(RuntimeError, match="engine closed"):
            b.submit(queries[0])


def test_health_map_contract():
    h = HealthMap(3)
    assert h.up_groups() == (0, 1, 2)
    assert h.mark_down(1) and not h.mark_down(1)
    assert h.up_groups() == (0, 2) and not h.is_up(1)
    assert h.generation == 1
    assert h.mark_up(1) and not h.mark_up(1)
    assert h.up_groups() == (0, 1, 2) and h.generation == 2
    with pytest.raises(ValueError, match="group must be in"):
        h.mark_down(3)
    with pytest.raises(ValueError, match="replica group"):
        HealthMap(0)


def test_readmit_is_drain_atomic():
    h = HealthMap(2)
    h.mark_down(1)
    assert h.readmit(1) and h.is_up(1)
    h.mark_down(1)
    gen = h.generation
    assert h.mark_down(1, drain=True)          # drain recorded while down
    assert h.generation == gen + 1
    assert not h.readmit(1) and not h.is_up(1)
    assert h.mark_up(1) and h.is_up(1) and not h.is_drained(1)
    assert not h.readmit(0)                    # an up group: nothing to do


# ----------------------------------------------------------- maintenance
def _check_clean(index, queries, live_ids):
    live_ids = set(live_ids)
    ids, scores = index.search(queries, k=10, page=10_000, engine="codes")
    ids, scores = ids.numpy(), scores.numpy()
    dead = ids == -1
    assert (np.isneginf(scores) == dead).all()
    assert all(i in live_ids for i in ids[~dead].ravel())


def test_auto_compact_lifecycle(sidx, queries):
    rng = np.random.default_rng(7)
    W = rng.normal(size=(12, N_FEAT)).astype(np.float32)
    cl = _mk_cluster([sidx, sidx], auto_compact=0.2, compact_interval_s=0.01)
    try:
        first = cl.add_documents(W)
        assert first == N_DOCS
        ids, s = cl.search(W[0], stream=0, timeout=WAIT)
        assert ids[0] == N_DOCS and abs(s[0] - 1) < 1e-5
        victims = list(range(0, 14)) + [N_DOCS + 1]
        cl.delete(victims)
        deadline = time.monotonic() + WAIT
        while cl.maintenance.compactions < 2:
            assert time.monotonic() < deadline, "daemon never compacted"
            ids, s = cl.search(queries[0], stream=0, timeout=WAIT)
            assert not np.isin(ids, victims).any()
        for g in range(2):
            idx = cl.group_index(g)
            assert idx.n_appended == 0 and idx.seg_capacity == 0
            assert idx.tombstone_ratio == 0.0
            _check_clean(idx, np.stack([queries[0], W[0]]),
                         set(range(N_DOCS + 12)) - set(victims))
        ids, s = cl.search(W[0], stream=1, timeout=WAIT)
        assert ids[0] == N_DOCS
        assert cl.maintenance.events[0]["tombstone_ratio"] > 0.2
    finally:
        cl.close()


def test_maintenance_cas_respects_racing_ingest(sidx):
    rng = np.random.default_rng(8)
    W = rng.normal(size=(8, N_FEAT)).astype(np.float32)
    eng = BatchedSearchEngine(sidx, batch_size=2, k=5, page=N_DOCS,
                              trim=None, engine="codes")
    try:
        eng.delete(list(range(14)))
        snapshot = eng.index
        compacted = snapshot.compact()
        first = eng.add_documents(W)                     # races the rebuild
        assert not eng.swap_index(compacted, expected=snapshot)
        assert eng.index.n_appended == 8
        daemon = MaintenanceDaemon([eng], threshold=0.2)
        assert daemon.poll_once() == 1
        idx = eng.index
        assert idx.n_appended == 0 and idx.tombstone_ratio == 0.0
        ids, _ = eng.search(W[3], timeout=WAIT)
        assert ids[0] == first + 3
    finally:
        eng.close()


def test_maintenance_quarantines_failing_rebuild(sidx):
    class _BadCompact:
        def __init__(self, inner):
            self.inner = inner
            self.compact_calls = 0

        def compact(self):
            self.compact_calls += 1
            raise RuntimeError("simulated device OOM")

        def __getattr__(self, name):
            return getattr(self.inner, name)

    bad = _BadCompact(sidx.delete(list(range(14))))
    eng = BatchedSearchEngine(bad, batch_size=2, trim=None)
    try:
        daemon = MaintenanceDaemon([eng], threshold=0.2)
        assert daemon.poll_once() == 0
        assert daemon.failures and "OOM" in daemon.failures[0]["error"]
        assert daemon.poll_once() == 0                   # quarantined...
        assert bad.compact_calls == 1                    # ...no hot loop
        eng.swap_index(sidx.delete(list(range(15))))
        daemon.poll_once()
        assert len(daemon.failures) == 1
        assert eng.index.tombstone_ratio == 0.0
    finally:
        eng.close()


def test_maintenance_skips_down_groups(sidx):
    e0 = BatchedSearchEngine(sidx, batch_size=2, trim=None)
    e1 = BatchedSearchEngine(sidx, batch_size=2, trim=None)
    try:
        e0.delete(list(range(14)))
        e1.delete(list(range(14)))
        health = HealthMap(2)
        health.mark_down(0)
        daemon = MaintenanceDaemon([e0, e1], threshold=0.2, health=health)
        assert daemon.pending_plans() == [
            {"group": 1, "kind": "compact",
             "tombstone_ratio": e1.index.tombstone_ratio}]
        assert daemon.poll_once() == 1
        assert e0.index.tombstone_ratio > 0.2
        assert e1.index.tombstone_ratio == 0.0
        assert daemon.pending_plans() == []
    finally:
        e0.close()
        e1.close()


def test_maintenance_validates():
    with pytest.raises(ValueError, match="threshold"):
        MaintenanceDaemon([], threshold=0.0)
    with pytest.raises(ValueError, match="probe"):
        MaintenanceDaemon([], probe=True)


# ---------------------------------------------------- data-plane hooks
def test_tombstone_accounting_is_exact(sidx):
    rng = np.random.default_rng(9)
    W = rng.normal(size=(6, N_FEAT)).astype(np.float32)
    assert sidx.tombstone_ratio == 0.0 and sidx.n_tombstones == 0
    grown = sidx.add_documents(W)
    pruned = grown.delete([0, 5, N_DOCS + 2])
    assert pruned.n_tombstones == 3
    assert pruned.tombstone_ratio == pytest.approx(3 / (N_DOCS + 6))
    again = pruned.delete([0, 5])
    assert again.n_tombstones == 3
    assert pruned.compact().n_tombstones == 0


def test_token_df_exact_under_tombstones_and_compact(sidx):
    rng = np.random.default_rng(10)
    W = rng.normal(size=(7, N_FEAT)).astype(np.float32)
    Q = rng.normal(size=(4, N_FEAT)).astype(np.float32)
    pruned = sidx.add_documents(W).delete([0, 3, 17, N_DOCS + 2])
    qcodes = pruned.encoder.encode(normalize(torch.from_numpy(Q))).numpy()
    C = pruned.codes.shape[-1]
    base = pruned.codes.numpy().reshape(-1, C)[: N_DOCS]
    live = pruned.live.numpy().reshape(-1)[: N_DOCS]
    seg = pruned.seg_codes.numpy().reshape(-1, C)
    sliv = pruned.seg_live.numpy().reshape(-1)
    live_codes = np.concatenate([base[live], seg[sliv]])
    expect = (qcodes[:, None, :] == live_codes[None, :, :]).sum(1)
    assert np.array_equal(pruned.token_df(Q).numpy(), expect)
    assert np.array_equal(pruned.compact().token_df(Q).numpy(), expect)


def test_idf_results_identical_across_compaction(sidx):
    rng = np.random.default_rng(11)
    W = rng.normal(size=(9, N_FEAT)).astype(np.float32)
    Q = rng.normal(size=(5, N_FEAT)).astype(np.float32)
    pruned = sidx.add_documents(W).delete([1, 4, 40, N_DOCS + 3])
    packed = pruned.compact()
    for engine in ("postings", "codes"):
        i1, s1 = pruned.search(Q, k=10, page=10_000, engine=engine,
                               weighting="idf")
        i2, s2 = packed.search(Q, k=10, page=10_000, engine=engine,
                               weighting="idf")
        assert torch.equal(i1, i2), engine
        np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=1e-6,
                                   err_msg=engine)


def test_adaptive_max_postings_exact_and_smaller(sidx):
    rng = np.random.default_rng(12)
    Q = rng.normal(size=(5, N_FEAT)).astype(np.float32)
    assert 1 <= sidx.max_df < sidx.docs_per_shard
    sentinel = _SENTINEL[sidx.codes.dtype]
    codes = sidx.codes.numpy().astype(np.int64)
    codes = codes.reshape(-1, codes.shape[-1])
    expect = max(np.bincount(col[col != sentinel] - col.min()).max()
                 for col in codes.T)
    assert sidx.max_df == expect
    ia, sa = sidx.search(Q, k=10, page=10_000, engine="postings",
                         max_postings="auto")
    ib, sb = sidx.search(Q, k=10, page=10_000, engine="postings",
                         max_postings=None)
    assert torch.equal(ia, ib) and torch.equal(sa, sb)
    e_auto = BatchedSearchEngine(sidx, batch_size=2, k=5, page=N_DOCS,
                                 trim=None, engine="postings",
                                 max_postings="auto")
    e_full = BatchedSearchEngine(sidx, batch_size=2, k=5, page=N_DOCS,
                                 trim=None, engine="postings")
    try:
        for q in Q:
            _same(e_auto.search(q, timeout=WAIT),
                  e_full.search(q, timeout=WAIT))
    finally:
        e_auto.close()
        e_full.close()


def test_replica_group_validates(sidx):
    with pytest.raises(ValueError, match="replica group"):
        sidx.replica_group(1)
    assert sidx.replica_group(0) is sidx


def test_live_groups_validates(sidx, queries):
    with pytest.raises(ValueError, match="live_groups"):
        sidx.search(queries, live_groups=())
    with pytest.raises(ValueError, match="live_groups"):
        sidx.search(queries, live_groups=(2,))
    ids, _ = sidx.search(queries, k=5, page=N_DOCS, live_groups=(0,))
    gi, _ = sidx.search(queries, k=5, page=N_DOCS)
    assert torch.equal(ids, gi)


# ------------------------------------------------------- 4x2 mesh parity
@pytest.mark.parametrize("engine", ENGINES)
def test_failover_parity_on_4x2_mesh(engine):
    """On 4 shards x 2 groups, answers after mark_down of EITHER group are
    bit-identical to the healthy cluster at page >= n_docs, through the
    routing path and the in-mesh health-masked merge."""
    rng = np.random.default_rng(0)
    V = rng.normal(size=(50, 12)).astype(np.float32)
    Q = np.concatenate([V[:4], rng.normal(size=(3, 12)).astype(np.float32)])
    s42 = ShardedVectorIndex.build_sharded(
        V, mesh=make_shard_mesh(4, 2, device="cpu"))
    cl = ClusterEngine(s42, batch_size=4, k=5, page=1000, trim=None,
                       engine=engine)
    try:
        assert cl.n_groups == 2
        healthy = [cl.submit(q, stream=i % 4) for i, q in enumerate(Q)]
        healthy = [f.result(timeout=WAIT) for f in healthy]
        for down in (0, 1):
            after = [cl.submit(q, stream=i % 4) for i, q in enumerate(Q)]
            cl.mark_down(down)          # in-flight futures drain normally
            after = [f.result(timeout=WAIT) for f in after]
            gone = [cl.submit(q, stream=i % 4) for i, q in enumerate(Q)]
            gone = [f.result(timeout=WAIT) for f in gone]
            for h, a, g in zip(healthy, after, gone):
                _same(h, a, (engine, down))
                _same(h, g, (engine, down))
            cl.mark_up(down)
    finally:
        cl.close()
    gi, gs = s42.search(Q, k=5, page=1000, engine=engine)
    for down in (0, 1):
        fi, fs = s42.search(Q, k=5, page=1000, engine=engine,
                            live_groups=(1 - down,))
        assert torch.equal(fi, gi) and torch.equal(fs, gs), (engine, down)
    for i, (ids, scores) in enumerate(healthy):
        assert np.array_equal(ids, gi[i].numpy())
        assert np.array_equal(scores, gs[i].numpy())


def test_cluster_ingest_failover_on_4x2_mesh():
    rng = np.random.default_rng(1)
    V = rng.normal(size=(37, 10)).astype(np.float32)
    W = rng.normal(size=(8, 10)).astype(np.float32)
    s42 = ShardedVectorIndex.build_sharded(
        V, mesh=make_shard_mesh(4, 2, device="cpu"))
    cl = ClusterEngine(s42, batch_size=2, k=3, page=1000, trim=None,
                       engine="codes")
    try:
        cl.mark_down(1)                       # writes reach down groups too
        assert cl.add_documents(W) == 37
        cl.delete([2, 11, 38])
        cl.mark_up(1)
        a = [cl.search(q, stream=0, timeout=WAIT) for q in W[:4]]
        cl.inject_failure(0)                  # stream 0 pinned to group 0
        b = [cl.search(q, stream=0, timeout=WAIT) for q in W[:4]]
        assert not cl.health.is_up(0)
        for x, y in zip(a, b):
            _same(x, y)
        assert b[0][0][0] == 37
        assert 38 not in b[1][0]
        cl.heal(0)
        cl.mark_up(0)
        daemon = MaintenanceDaemon(cl.batchers, threshold=0.05)
        assert daemon.poll_once() == 2
        for g in range(2):
            idx = cl.group_index(g)
            assert idx.n_appended == 0 and idx.tombstone_ratio == 0.0
        ids, _ = cl.search(W[0], stream=1, timeout=WAIT)
        assert ids[0] == 37
    finally:
        cl.close()


# ------------------------------------------- donation and shared tensors
def _tensors(idx):
    out = {f"{n}": getattr(idx, n) for n in LEAVES}
    for i, seg in enumerate(idx.segments):
        out.update({f"seg{i}.{n}": getattr(seg, n) for n in SEG_LEAVES})
    return out


def test_sibling_tensors_untouched_by_ingest():
    """Groups of one index share every tensor; a write through one
    group's batcher builds that group new tensors and never writes a
    shared one, so each group's served snapshot keeps its values, and
    the batchers never donate (the failpoint's ``add_documents`` names no
    ``donate``)."""
    rng = np.random.default_rng(3)
    V = rng.normal(size=(41, 10)).astype(np.float32)
    s42 = ShardedVectorIndex.build_sharded(
        V, mesh=make_shard_mesh(4, 2, device="cpu")).add_documents(
            rng.normal(size=(3, 10)).astype(np.float32))
    assert s42.seg_capacity > 1                    # a batch now fits
    cl = ClusterEngine(s42, batch_size=2, k=3, page=1000, trim=None,
                       engine="codes")
    try:
        snaps = [cl.group_index(g) for g in range(2)]
        assert snaps[0].seg_vectors is snaps[1].seg_vectors
        before = [{n: t.clone() for n, t in _tensors(s).items()}
                  for s in snaps]
        cl.add_documents(rng.normal(size=(3, 10)).astype(np.float32))
        cl.delete([0, 42])
        for s, b in zip(snaps, before):
            for n, t in _tensors(s).items():
                assert torch.equal(t, b[n]), n
        assert (cl.group_index(0).seg_vectors
                is not cl.group_index(1).seg_vectors)
        fp = cl._failpoints[0]
        assert "donate" not in inspect.signature(
            fp.add_documents).parameters
    finally:
        cl.close()
    # a donating engine in front of a failpoint still never donates
    idx = s42.replica_group(0)
    keep = {n: t.clone() for n, t in _tensors(idx).items()}
    eng = BatchedSearchEngine(_FailpointIndex(idx), batch_size=2,
                              trim=None, donate_ingest=True)
    try:
        eng.add_documents(rng.normal(size=(3, 10)).astype(np.float32))
    finally:
        eng.close()
    for n, t in _tensors(idx).items():
        assert torch.equal(t, keep[n]), n


# ------------------------------------------------ durability and restore
def _build(n_docs=30, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n_docs, 10)).astype(np.float32), rng


def _same_leaves(a, b, ctx):
    for n in LEAVES:
        assert torch.equal(getattr(a, n), getattr(b, n)), (ctx, n)
    assert a.n_segments == b.n_segments, ctx
    for sa, sb in zip(a.segments, b.segments):
        for n in SEG_LEAVES:
            assert torch.equal(getattr(sa, n), getattr(sb, n)), (ctx, n)
        assert (sa.n_rows, sa.tombstones) == (sb.n_rows, sb.tombstones)
    for n in ("n_docs", "n_appended", "shard_tombstones", "seg_base",
              "active_tombstones"):
        assert getattr(a, n) == getattr(b, n), (ctx, n)


def test_daemon_commits_after_compaction(tmp_path):
    V, rng = _build()
    Q = rng.normal(size=(3, 10)).astype(np.float32)
    store = Store(str(tmp_path))
    idx = store.open_index(ShardedVectorIndex.build_sharded(V, device="cpu"))
    eng = BatchedSearchEngine(idx, batch_size=2, trim=None, engine="codes")
    try:
        eng.delete(list(range(9)))                   # ratio 0.3 > 0.2
        daemon = MaintenanceDaemon([eng], threshold=0.2, store=store)
        assert daemon.poll_once() == 1
        assert daemon.commits == 1 and not daemon.failures
        assert eng.index.translog_seq == 1
        commit = latest_commit(str(tmp_path))
        assert commit.seq == 1
        assert not list(read_ops(str(tmp_path), after_seq=commit.seq))
        rec, seq = recover(str(tmp_path), device="cpu")
        assert seq == 1
        _same_leaves(eng.index.inner, rec, "daemon commit")
        for engine in ENGINES:
            a = eng.index.search(Q, k=5, page=200, engine=engine)
            b = rec.search(Q, k=5, page=200, engine=engine)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    finally:
        eng.close()
    store.close()


def test_cluster_restore_group_readmits_from_disk(tmp_path):
    V, rng = _build()
    W = rng.normal(size=(5, 10)).astype(np.float32)
    Q = rng.normal(size=(4, 10)).astype(np.float32)
    sidx = ShardedVectorIndex.build_sharded(V, device="cpu")
    store = Store(str(tmp_path))
    cl = ClusterEngine([sidx, sidx], batch_size=4, k=5, page=200, trim=None,
                       engine="codes", store=store,
                       metrics=MetricsRegistry())
    try:
        cl.add_documents(W)
        cl.delete([0, 31])
        ref = [cl.search(q, stream="a", timeout=WAIT) for q in Q]
        cl.inject_failure(1)
        cl.mark_down(1)
        seq = cl.restore_group(1)
        assert seq == 2 and cl.health.is_up(1)
        got = [cl.search(q, stream="pin-b", timeout=WAIT) for q in Q]
        for a, b in zip(ref, got):
            _same(a, b)
        cl.mark_down(0)
        cl.restore_group(0)
        assert cl.health.is_up(0)
        first = cl.add_documents(W[:2])              # still logs: seq moves
        assert first == 35 and store.seqno == 3
        assert cl.cluster_health()["restores_completed"] == 2
    finally:
        cl.close()
    store.close()


def test_cluster_without_store_rejects_restore():
    V, _ = _build()
    sidx = ShardedVectorIndex.build_sharded(V, device="cpu")
    cl = ClusterEngine([sidx, sidx], batch_size=2, trim=None)
    try:
        with pytest.raises(RuntimeError, match="no store attached"):
            cl.restore_group(1)
    finally:
        cl.close()


def test_cluster_restore_group_on_4x2_mesh(tmp_path):
    """On 4 shards x 2 groups: group 1 is poisoned and drained, the
    cluster keeps writing, and restore_group rebuilds it from disk onto
    its own mesh column -- every leaf equal to group 0's, answers bit
    for bit, for every engine."""
    rng = np.random.default_rng(2)
    V = rng.normal(size=(41, 10)).astype(np.float32)
    W = rng.normal(size=(7, 10)).astype(np.float32)
    Q = rng.normal(size=(5, 10)).astype(np.float32)
    s42 = ShardedVectorIndex.build_sharded(
        V, mesh=make_shard_mesh(4, 2, device="cpu"), seal_threshold=4)
    store = Store(str(tmp_path))
    cl = ClusterEngine(s42, batch_size=4, k=5, page=1000, trim=None,
                       engine="codes", store=store,
                       metrics=MetricsRegistry())
    try:
        cl.add_documents(W[:4])
        cl.inject_failure(1)
        cl.mark_down(1)
        cl.add_documents(W[4:])        # acked while group 1 is down
        cl.delete([3, 42])
        ref = [cl.search(q, stream="a", timeout=WAIT) for q in Q]
        seq = cl.restore_group(1)
        assert seq == 3 and cl.health.is_up(1)
        assert cl.cluster_health()["restores_completed"] == 1
        g0, g1 = cl.group_index(0).inner, cl.group_index(1)
        assert g1.n_shards == 4 and g1.n_replicas == 1
        assert g1.vectors.data_ptr() != g0.vectors.data_ptr()
        _same_leaves(g0, g1, "restored group 1")
        got = [cl.search(q, stream="pin-elsewhere", timeout=WAIT) for q in Q]
        for a, b in zip(ref, got):
            _same(a, b)
        for engine in ENGINES:
            a = g0.search(Q, k=5, page=1000, engine=engine)
            b = g1.search(Q, k=5, page=1000, engine=engine)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    finally:
        cl.close()
    store.close()


def test_store_passes_mesh_by_keyword(tmp_path):
    """restore_group hands the group's mesh to the store by keyword: the
    store's first positional is a device."""
    V, _ = _build()
    s42 = ShardedVectorIndex.build_sharded(
        V, mesh=make_shard_mesh(4, 2, device="cpu"))
    store = Store(str(tmp_path))
    seen = {}
    real = store.recover_index

    def spy(*args, **kwargs):
        seen["args"], seen["kwargs"] = args, kwargs
        return real(*args, **kwargs)

    store.recover_index = spy
    cl = ClusterEngine(s42, batch_size=2, trim=None, store=store)
    try:
        cl.restore_group(1)
        assert seen["args"] == ()
        assert seen["kwargs"]["mesh"] == s42.mesh.column(1)
    finally:
        cl.close()
    store.close()


# --------------------------------------------------------- health probing
def test_probe_readmits_healed_group():
    V, _ = _build()
    sidx = ShardedVectorIndex.build_sharded(V, device="cpu")
    cl = ClusterEngine([sidx, sidx], batch_size=2, k=3, page=30, trim=None,
                       engine="codes")
    try:
        daemon = MaintenanceDaemon(cl.batchers, health=cl.health, probe=True)
        cl.inject_failure(1)
        cl.health.mark_down(1)
        assert daemon.probe_once() == 0 and not cl.health.is_up(1)
        cl.heal(1)
        assert daemon.probe_once() == 1 and cl.health.is_up(1)
        assert daemon.probe_events == [{"group": 1}]
        assert daemon.probe_once() == 0
    finally:
        cl.close()


def test_probe_respects_operator_drain():
    V, _ = _build()
    sidx = ShardedVectorIndex.build_sharded(V, device="cpu")
    cl = ClusterEngine([sidx, sidx], batch_size=2, k=3, page=30, trim=None,
                       engine="codes")
    try:
        daemon = MaintenanceDaemon(cl.batchers, health=cl.health, probe=True)
        cl.mark_down(1)
        assert cl.health.is_drained(1)
        assert daemon.probe_once() == 0 and not cl.health.is_up(1)
        assert cl.mark_up(1)
        assert not cl.health.is_drained(1) and cl.health.is_up(1)
    finally:
        cl.close()


def test_probe_background_loop_readmits():
    """ClusterEngine(probe_s=...) runs the prober on the daemon thread:
    a failed canary leaves the group down, and heal() alone brings it
    back."""
    V, _ = _build()
    sidx = ShardedVectorIndex.build_sharded(V, device="cpu")
    reg = MetricsRegistry()
    cl = ClusterEngine([sidx, sidx], batch_size=2, k=3, page=30, trim=None,
                       engine="codes", probe_s=0.01, metrics=reg)
    try:
        assert cl.maintenance is not None and cl.maintenance.probe
        assert cl.maintenance.merge_policy is None
        cl.inject_failure(1)
        cl.health.mark_down(1)
        _wait_until(lambda: reg.value("engine.requests.failed", group=1)
                    >= 1, "no canary reached the faulty group")
        assert not cl.health.is_up(1)
        cl.heal(1)
        _wait_until(lambda: cl.health.is_up(1), "prober never re-admitted")
        assert reg.total("maintenance.probe.readmits") == 1
    finally:
        cl.close()


# ----------------------------------------------------------- merge policy
def _fake_index(*rows_tombs):
    segs = tuple(types.SimpleNamespace(n_rows=r, tombstones=t,
                                       deleted_ratio=t / max(r, 1))
                 for r, t in rows_tombs)
    return types.SimpleNamespace(segments=segs)


def test_merge_policy_validates():
    with pytest.raises(ValueError, match="merge_factor"):
        TieredMergePolicy(merge_factor=1)
    with pytest.raises(ValueError, match="segment_deletes"):
        TieredMergePolicy(segment_deletes=0.0)


def test_merge_policy_none_without_segments():
    pol = TieredMergePolicy()
    assert pol.select(_fake_index()) is None
    assert pol.select(types.SimpleNamespace()) is None


def test_merge_policy_delete_pressure_beats_tier():
    pol = TieredMergePolicy(merge_factor=2, segment_deletes=0.2)
    sel = pol.select(_fake_index((8, 0), (8, 3), (8, 0)))
    assert sel == {"start": 1, "count": 1, "reason": "deletes",
                   "deleted_ratio": pytest.approx(3 / 8)}


def test_merge_policy_tier_window():
    pol = TieredMergePolicy(merge_factor=2, segment_deletes=0.5)
    assert pol.select(_fake_index((100, 0), (4, 0))) is None
    sel = pol.select(_fake_index((100, 0), (4, 0), (5, 0)))
    assert sel == {"start": 1, "count": 2, "reason": "tier"}
    assert pol.select(_fake_index((6, 0))) is None


@pytest.mark.parametrize("seed", range(4))
def test_merge_policy_equals_reference(seed):
    """Seeded segment lists (empty, zero-row, all-dead, a ratio exactly at
    the limit, giants beside minis) plan the same merge in both
    packages."""
    rng = np.random.default_rng(seed)
    edge = [(), ((0, 0),), ((4, 4), (4, 0)), ((10, 2), (10, 0)),
            ((1000, 0), (1, 0), (1, 0), (1, 0), (1, 0)),
            ((8, 0), (8, 0), (32, 0), (32, 0))]
    cases = [_fake_index(*c) for c in edge]
    for _ in range(60):
        n = int(rng.integers(0, 12))
        rows = rng.choice([0, 1, 4, 8, 64, 4096], size=n)
        dead = [int(rng.integers(0, r + 1)) if rng.random() < 0.4 else 0
                for r in rows]
        cases.append(_fake_index(*zip(rows.tolist(), dead)))
    for mf, sd in ((2, 0.2), (3, 0.5), (4, 0.2), (10, 1.0)):
        mine, theirs = TieredMergePolicy(mf, sd), JPolicy(mf, sd)
        for c in cases:
            assert mine.select(c) == theirs.select(c), (mf, sd, c)


def test_merge_policy_reads_the_ports_segments():
    """The planner reads the port's own Segment (``deleted_ratio``,
    ``n_rows``) as the reference's planner does."""
    rng = np.random.default_rng(5)
    idx = ShardedVectorIndex.build_sharded(
        rng.normal(size=(16, N_FEAT)).astype(np.float32), device="cpu",
        seal_threshold=4)
    for _ in range(4):
        idx = idx.add_documents(rng.normal(size=(4, N_FEAT))
                                .astype(np.float32))
    idx2 = idx.delete([17, 18])
    for i in (idx, idx2):
        assert TieredMergePolicy().select(i) == JPolicy().select(i)
    assert TieredMergePolicy().select(idx2)["reason"] == "deletes"
    assert TieredMergePolicy().select(idx)["reason"] == "tier"


def _segmented_engine(rng, *, n_docs=16, adds=3):
    sidx = ShardedVectorIndex.build_sharded(
        rng.normal(size=(n_docs, N_FEAT)).astype(np.float32), device="cpu",
        seal_threshold=4)
    for _ in range(adds):
        sidx = sidx.add_documents(rng.normal(size=(4, N_FEAT))
                                  .astype(np.float32))
    return BatchedSearchEngine(sidx, batch_size=2, trim=None, engine="codes")


def test_daemon_applies_planned_merges_concurrently():
    rng = np.random.default_rng(3)
    reg = MetricsRegistry()
    engines = [_segmented_engine(rng), _segmented_engine(rng)]
    try:
        daemon = MaintenanceDaemon(
            engines, threshold=0.9, metrics=reg,
            merge_policy=TieredMergePolicy(merge_factor=3))
        for e in engines:
            assert e.index.n_segments == 3
        assert daemon.poll_once() == 2
        assert daemon.merges == 2 and daemon.compactions == 0
        assert not daemon.failures
        for e in engines:
            assert e.index.n_segments == 1
        assert sorted(ev["group"] for ev in daemon.merge_events) == [0, 1]
        for ev in daemon.merge_events:
            assert ev["reason"] == "tier"
            assert (ev["start"], ev["count"]) == (0, 3)
        assert reg.series("maintenance.merges") == \
            {"group=0": 1, "group=1": 1}
        assert daemon.poll_once() == 0
    finally:
        for e in engines:
            e.close()


def test_daemon_delete_pressure_singleton_rewrite():
    rng = np.random.default_rng(4)
    reg = MetricsRegistry()
    eng = _segmented_engine(rng)
    try:
        eng.delete([18, 19])
        snapshot = eng.index
        assert snapshot.segments[0].deleted_ratio == pytest.approx(0.5)
        daemon = MaintenanceDaemon(
            [eng], threshold=0.9, metrics=reg,
            merge_policy=TieredMergePolicy(merge_factor=4,
                                           segment_deletes=0.2))
        assert daemon.poll_once() == 1
        ev = daemon.merge_events[0]
        assert ev["reason"] == "deletes"
        assert (ev["start"], ev["count"], ev["reclaimed"]) == (0, 1, 2)
        assert eng.index.segments[0].tombstones == 0
        assert eng.index.segments[0].n_rows == 2
        assert reg.series("maintenance.merge.reclaimed") == {"group=0": 2}
        # the swapped index answers as an explicit merge on the snapshot
        Q = rng.normal(size=(3, N_FEAT)).astype(np.float32)
        want = snapshot.merge_segments(0, 1).search(Q, k=5, page=100)
        got = eng.index.search(Q, k=5, page=100)
        assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    finally:
        eng.close()


def test_daemon_merge_policy_off_keeps_old_behavior():
    rng = np.random.default_rng(5)
    eng = _segmented_engine(rng)
    try:
        daemon = MaintenanceDaemon([eng], threshold=0.9, merge_policy=None)
        assert daemon.poll_once() == 0
        assert eng.index.n_segments == 3
    finally:
        eng.close()


def test_daemon_background_loop_merges_and_stops():
    rng = np.random.default_rng(6)
    eng = _segmented_engine(rng)
    daemon = MaintenanceDaemon([eng], threshold=0.9, interval_s=0.01,
                               merge_policy=TieredMergePolicy(3)).start()
    try:
        _wait_until(lambda: daemon.merges == 1, "daemon never merged")
    finally:
        daemon.stop()
        eng.close()
    assert daemon._thread is None and eng.index.n_segments == 1


# --------------------------------------------- stats, traces and profiles
def test_trace_records_spill_event(sidx, queries):
    gated = _Gated(sidx)
    reg = MetricsRegistry()
    tr = Tracer(sample=1.0)
    cl = ClusterEngine([gated, sidx], batch_size=1, k=5, page=N_DOCS,
                       trim=None, engine="codes", spill_factor=2.0,
                       metrics=reg, tracer=tr)
    try:
        futs = [cl.submit(queries[0], stream="s")]
        assert gated.entered.wait(timeout=WAIT)
        futs += [cl.submit(q, stream="s") for q in queries[1:3]]
        cl.submit(queries[3], stream="s").result(timeout=WAIT)
        assert reg.value("cluster.routing.spills") == 1
        (trace,) = tr.dump()
        events = [(e["name"], e["attrs"]) for s in trace["spans"]
                  for e in s["events"]]
        assert ("spill", {"from_group": 0, "to_group": 1}) in events
        dispatch = [s for s in trace["spans"] if s["name"] == "dispatch"]
        assert [s["attrs"]["group"] for s in dispatch] == [1]
        gated.release.set()
        for f in futs:
            f.result(timeout=WAIT)
    finally:
        gated.release.set()
        cl.close()


def test_trace_records_failover_resubmit(sidx, queries):
    reg = MetricsRegistry()
    tr = Tracer(sample=1.0)
    cl = ClusterEngine([sidx, sidx], batch_size=4, k=5, page=N_DOCS,
                       trim=None, engine="codes", metrics=reg, tracer=tr)
    try:
        cl.search(queries[0], stream="s", timeout=WAIT)
        cl.inject_failure(0)
        cl.search(queries[1], stream="s", timeout=WAIT)
        assert reg.value("cluster.failover.resubmits") == 1
        assert reg.total("health.down_transitions") == 1
        trace = tr.dump()[-1]
        assert trace["t1"] is not None and "error" not in trace["attrs"]
        events = {e["name"] for s in trace["spans"] for e in s["events"]}
        assert {"group_down", "failover_resubmit"} <= events
        dispatch = [s for s in trace["spans"] if s["name"] == "dispatch"]
        by_group = {s["attrs"]["group"]: s for s in dispatch}
        assert sorted(by_group) == [0, 1]
        assert "error" in by_group[0]["attrs"]
        assert "error" not in by_group[1]["attrs"]
        cl.heal(0)
        assert cl.health.readmit(0)
        assert reg.total("health.readmits") == 1
    finally:
        cl.close()


def test_lifecycle_stats_reconcile_exactly(sidx, queries, tmp_path):
    """Serve, hot ingest, injected failure + failover, readmit,
    background compaction with commits, restore from disk: every query
    issued is counted once at cluster level and once in some group's
    completions; one injected failure is one down transition."""
    rng = np.random.default_rng(7)
    W = rng.normal(size=(12, N_FEAT)).astype(np.float32)
    reg = MetricsRegistry()
    tr = Tracer(sample=1.0)
    store = Store(str(tmp_path))
    cl = ClusterEngine([sidx, sidx], batch_size=4, k=5, page=10_000,
                       trim=None, engine="codes", metrics=reg, tracer=tr,
                       store=store, auto_compact=0.2,
                       compact_interval_s=0.01)
    n_issued = 0
    try:
        assert store.metrics is reg
        for i, q in enumerate(queries[:4]):
            cl.search(q, stream=i % 2, timeout=WAIT)
            n_issued += 1
        assert cl.add_documents(W) == N_DOCS
        assert store.seqno == 1
        cl.search(W[0], stream=0, timeout=WAIT)
        n_issued += 1
        cl.inject_failure(0)
        cl.search(W[1], stream=None, timeout=WAIT)
        n_issued += 1
        cl.search(queries[4], stream=0, timeout=WAIT)
        n_issued += 1
        cl.heal(0)
        assert cl.health.readmit(0)
        cl.delete(list(range(0, 14)) + [N_DOCS + 1])
        assert store.seqno == 2
        deadline = time.monotonic() + WAIT
        while cl.maintenance.compactions < 2:
            assert time.monotonic() < deadline, "daemon never compacted"
            cl.search(queries[5], stream=1, timeout=WAIT)
            n_issued += 1
        assert cl.restore_group(1) == 2
        a = cl.search(W[2], stream=0, timeout=WAIT)
        b = cl.search(W[2], stream=1, timeout=WAIT)
        n_issued += 2
        _same(a, b)
        st = cl.stats()
        req = st["requests"]
        assert req["submitted"] == req["completed"] == n_issued
        assert req["failed"] == 0
        assert sum(req["group_completed"].values()) == n_issued
        assert st["health"]["down_transitions"] == 1
        assert st["health"]["readmits"] == 1
        assert st["routing"]["failover_resubmits"] >= 1
        assert all(g["health"] == "up" for g in st["groups"].values())
        assert sum(g["requests"]["completed"]
                   for g in st["groups"].values()) >= n_issued
        assert st["maintenance"]["compactions"] >= 2
        assert st["store"]["recoveries"] == 1
        assert st["store"]["commits"] >= 2
        assert st["store"]["translog"]["seqno"] == 2
        assert "groups=2/2up" in format_stats_line(st)
        ts = tr.stats()
        assert ts["seen"] == ts["sampled"] == n_issued
        assert all(d["t1"] is not None for d in tr.dump())
    finally:
        cl.close()
        store.close()


def test_cluster_profile_routing_and_counters(sidx, queries):
    reg = MetricsRegistry()
    cl = ClusterEngine([sidx, sidx], batch_size=4, k=5, page=N_DOCS,
                       trim=None, engine="codes", metrics=reg)
    try:
        ids, scores, tree = cl.profile(queries[0], stream="s")
        _same((ids, scores), cl.search(queries[0], stream="s", timeout=WAIT))
        assert tree["name"] == "cluster.query"
        assert tree["attrs"]["n_groups"] == 2
        route, query = tree["children"]
        assert route["name"] == "route"
        assert route["attrs"]["up_groups"] == 2
        assert query["name"] == "query"
        assert query["attrs"]["group"] == route["attrs"]["group"]
        assert reg.value("cluster.requests.submitted") == 2
        assert reg.value("cluster.requests.completed") == 2
        g = route["attrs"]["group"]
        assert reg.value("cluster.requests.group_completed", group=g) == 2
    finally:
        cl.close()


def test_cluster_health_transitions_reconcile(sidx, queries):
    reg = MetricsRegistry()
    cl = ClusterEngine([sidx, sidx], batch_size=4, k=5, page=N_DOCS,
                       trim=None, engine="codes", metrics=reg)
    try:
        h = cl.cluster_health()
        assert h["status"] == "green"
        assert h["up_groups"] == h["n_groups"] == 2
        assert h["transitions"] == [] and h["pending_requests"] == 0
        assert "2/2up" in format_health_line(h)
        cl.mark_down(0)
        h = cl.cluster_health()
        assert h["status"] == "yellow" and list(h["down"]) == [0]
        assert "down=0" in format_health_line(h)
        cl.mark_down(1)
        h = cl.cluster_health()
        assert h["status"] == "red" and h["up_groups"] == 0
        cl.mark_up(0)
        cl.mark_up(1)
        h = cl.cluster_health()
        assert h["status"] == "green"
        events = [e["event"] for e in h["transitions"]]
        assert events.count("down") == 2 and events.count("up") == 2
        assert h["counters"]["down_transitions"] == 2
        assert h["counters"]["mark_ups"] == 2
        gens = [e["generation"] for e in h["transitions"]]
        assert gens == sorted(gens) and gens[-1] == h["generation"]
        futs = [cl.submit(v, stream=i) for i, v in enumerate(queries)]
        assert all(f.result(timeout=WAIT) for f in futs)
    finally:
        cl.close()


def test_cluster_health_lists_pending_maintenance(sidx):
    cl = _mk_cluster([sidx, sidx], auto_compact=0.2,
                     compact_interval_s=3600.0)
    try:
        cl.delete(list(range(14)))
        plans = cl.cluster_health()["pending_maintenance"]
        assert [(p["group"], p["kind"]) for p in plans] == \
            [(0, "compact"), (1, "compact")]
        assert "maint=2" in format_health_line(cl.cluster_health())
    finally:
        cl.close()


def test_group_ranges_name_the_group(sidx, queries):
    """With a tracer that annotates, each group's searches run in a
    profiler range named by the group, so a trace of concurrent
    batchers attributes each search to its group."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    cl = _mk_cluster([sidx, sidx], tracer=Tracer(sample=1.0, annotate=True))
    plain = _mk_cluster([sidx, sidx])
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            a = cl.search(queries[0], stream="x", timeout=WAIT)
            cl.mark_down(0)                  # stream y lands on group 1
            b = cl.search(queries[1], stream="y", timeout=WAIT)
        names = {e.name for e in prof.events()}
        assert {"repro.cluster.group0", "repro.cluster.group1"} <= names
        _same(a, plain.search(queries[0], stream="x", timeout=WAIT))
        _same(b, plain.search(queries[1], stream="y", timeout=WAIT))
        assert plain._failpoints[0]._cell["range"] is None
    finally:
        cl.close()
        plain.close()


def test_closed_cluster_frees_its_groups_without_the_collector(tmp_path):
    """A request keeps its state on an object, not in closures that name
    each other: after routing, spills, writes, a restore from disk, a
    daemon and a tracer, a closed cluster and every group's tensors are
    freed with the cyclic collector off.  After a failover, a failed
    search's traceback ties frames to futures in a cycle, which the
    collector frees."""
    import gc
    import weakref

    rng = np.random.default_rng(4)
    V = rng.normal(size=(41, 10)).astype(np.float32)
    Q = rng.normal(size=(6, 10)).astype(np.float32)

    def lifecycle(fail):
        s42 = ShardedVectorIndex.build_sharded(
            V, mesh=make_shard_mesh(4, 2, device="cpu"))
        store = Store(str(tmp_path / str(fail)))
        cl = ClusterEngine(s42, batch_size=2, k=3, page=1000, trim=None,
                           store=store, probe_s=3600.0,
                           metrics=MetricsRegistry(),
                           tracer=Tracer(sample=1.0))
        for i, q in enumerate(Q):
            cl.search(q, stream=i % 3, timeout=WAIT)
        if fail:
            cl.inject_failure(0)
            cl.search(Q[0], stream=0, timeout=WAIT)      # fails over
            cl.heal(0)
        cl.add_documents(V[:3])
        cl.delete([1])
        cl.restore_group(1)
        cl.search(Q[2], stream=5, timeout=WAIT)
        refs = [weakref.ref(t) for t in (
            s42.vectors, cl.group_index(0).seg_vectors,
            cl.group_index(1).vectors)] + [weakref.ref(cl)]
        cl.close()
        store.close()
        return refs

    gc.collect()
    gc.disable()
    try:
        assert [r() for r in lifecycle(False)] == [None] * 4
        refs = lifecycle(True)
    finally:
        gc.enable()
    gc.collect()
    assert [r() for r in refs] == [None] * 4


# ------------------------------------------------- cross-package oracles
_HEALTH_OPS = ("down", "drain", "up", "readmit")


@pytest.mark.parametrize("seed,n_ops", [(0, 200), (1, 200), (2, 3000)])
def test_health_map_equals_reference(seed, n_ops):
    """The same seeded mark_down / drain / mark_up / readmit history on
    both packages' HealthMap: equal returns at every step, and equal
    ledgers (capped in the 3000-op case), snapshots, generations and
    counter totals."""
    rng = np.random.default_rng(seed)
    regs = MetricsRegistry(), JRegistry()
    mine, theirs = HealthMap(3, metrics=regs[0]), JHealthMap(3,
                                                           metrics=regs[1])
    for _ in range(n_ops):
        op, g = _HEALTH_OPS[rng.integers(4)], int(rng.integers(3))
        outs = []
        for h in (mine, theirs):
            if op == "down":
                outs.append(h.mark_down(g))
            elif op == "drain":
                outs.append(h.mark_down(g, drain=True))
            elif op == "up":
                outs.append(h.mark_up(g))
            else:
                outs.append(h.readmit(g))
        assert outs[0] == outs[1], (op, g)
        assert mine.up_groups() == theirs.up_groups()
    assert mine.transitions() == theirs.transitions()
    assert mine.snapshot() == theirs.snapshot()
    assert mine.generation == theirs.generation
    for name in ("health.down_transitions", "health.readmits",
                 "health.mark_ups"):
        assert regs[0].total(name) == regs[1].total(name), name
        assert regs[0].series(name) == regs[1].series(name), name
    if n_ops > 1024:
        assert len(mine.transitions()) == 1024


def _ref_and_port_groups(n_docs=60, seed=0):
    """A reference flat VectorIndex and the port's from its leaves."""
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n_docs, N_FEAT)).astype(np.float32)
    jv = JVectorIndex.build(V)
    pv = interop.index_from_numpy(
        np.asarray(jv.vectors), np.asarray(jv.codes),
        np.asarray(jv.postings.post_docs),
        np.asarray(jv.postings.post_codes), RoundingEncoder(2), None,
        device="cpu")
    return jv, pv


def _agree(mine, theirs, ctx):
    """ids equal away from near-ties, scores within TOL."""
    (mi, ms), (ti, ts) = mine, theirs
    np.testing.assert_allclose(ms, ts, rtol=0, atol=TOL, err_msg=str(ctx))
    gaps = np.abs(np.diff(np.asarray(ts, np.float64)))
    clear = np.concatenate([[True], gaps > 2 * TOL]) & \
        np.concatenate([gaps > 2 * TOL, [True]])
    assert np.array_equal(np.asarray(mi)[clear], np.asarray(ti)[clear]), ctx


def _health_view(h):
    return {k: h[k] for k in ("status", "n_groups", "up_groups", "down",
                              "drained", "generation", "restores_completed",
                              "pending_maintenance", "transitions",
                              "counters")}


@pytest.mark.parametrize("engine", ("codes", "postings", "fused",
                                    "fused_int8"))
def test_cluster_answers_equal_reference(engine, queries):
    """The port's ClusterEngine over interop groups and the reference's
    over its flat VectorIndex groups, driven by the same requests:
    routing, an injected failure and its failover, a drain with work in
    flight, a full outage and its rollback -- equal answers (within the
    reference suite's tolerance, ids away from ties), equal health and
    routing counters."""
    jv, pv = _ref_and_port_groups()
    regs = MetricsRegistry(), JRegistry()
    opts = dict(batch_size=4, k=5, page=N_DOCS, trim=None, engine=engine)
    mine = ClusterEngine([pv, pv, pv], metrics=regs[0], **opts)
    theirs = JCluster([jv, jv, jv], metrics=regs[1], **opts)
    both = (mine, theirs)
    try:
        def step(q, stream, ctx):
            a, b = (c.search(q, stream=stream, timeout=WAIT) for c in both)
            _agree(a, b, ctx)

        for i, q in enumerate(queries):
            step(q, i % 4, ("routing", i))
        for c in both:
            c.inject_failure(0)
        for i, q in enumerate(queries[:4]):
            step(q, 0, ("failover", i))              # stream 0 on group 0
        for c in both:
            c.heal(0)
            assert c.health.readmit(0)
            assert c.mark_down(1)                    # drain group 1
        for i, q in enumerate(queries[4:]):
            step(q, i, ("drained", i))
        for c in both:
            assert c.mark_up(1)
            for g in range(3):
                c.inject_failure(g, RuntimeError("bad request"))
        for c in both:
            with pytest.raises(RuntimeError, match="bad request"):
                c.search(queries[0], stream="z", timeout=WAIT)
            for g in range(3):
                c.heal(g)
        step(queries[1], "z", "after rollback")
        hm, ht = (_health_view(c.cluster_health()) for c in both)
        assert hm == ht
        assert hm["status"] == "green"
        sm, st = mine.stats(), theirs.stats()
        for key in ("requests", "routing", "health"):
            assert sm[key] == st[key], key
        assert set(sm) == set(st)
        for g in sm["groups"]:
            assert set(sm["groups"][g]) == set(st["groups"][g])
            assert sm["groups"][g]["health"] == st["groups"][g]["health"]
            assert sm["groups"][g]["requests"] == st["groups"][g]["requests"]
    finally:
        for c in both:
            c.close()


def test_format_health_line_equals_reference():
    from repro.obs.stats import format_health_line as jformat

    base = {"status": "yellow", "up_groups": 1, "n_groups": 3,
            "down": (0, 2), "drained": (2,), "pending_requests": 7,
            "in_flight_restores": 1, "pending_maintenance": [{}],
            "generation": 9}
    for h in (base, {**base, "down": (), "drained": (), "status": "green"}):
        assert format_health_line(h) == jformat(h)


# ----------------------------------------------------- launch counters
class _CudaStub:
    """Stands in for a CUDA tensor: the wrappers read ``is_cuda`` and
    ``shape`` before they launch."""

    is_cuda = True
    shape = (8, 4)


class _YieldingKernel:
    """A wrapper's ``kernel`` module with the launch replaced by a
    counting stub, and ``KERNELS_PER_CALL`` read through a property that
    gives the interpreter away: a count updated outside a lock then loses
    increments to the other threads."""

    def __init__(self, real, fn):
        self._real, self._fn = real, fn
        self.made = 0
        self._lock = threading.Lock()

    @property
    def KERNELS_PER_CALL(self):
        time.sleep(0)
        return self._real.KERNELS_PER_CALL

    def __getattr__(self, name):
        if name != self._fn:
            return getattr(self._real, name)

        def launch(*args, **kwargs):
            with self._lock:
                self.made += 1
            return (None, types.SimpleNamespace(body="bulk")) \
                if name == "launch" else None
        return launch


@pytest.mark.parametrize("name", ("fused_phase1", "fused_phase1_quant",
                                  "code_match", "bucketize", "rerank_topk"))
def test_launch_counters_exact_under_threads(name, monkeypatch):
    """8 threads launch through one wrapper at once, through a counting
    stub of the launch: the wrapper's count is exactly the CUDA kernels
    of the launches made (and rerank_topk's count by body agrees)."""
    from repro_torch.kernels.bucketize import ops as bk_ops
    from repro_torch.kernels.code_match import ops as cm_ops
    from repro_torch.kernels.fused_phase1 import ops as fp_ops
    from repro_torch.kernels.rerank_topk import ops as rk_ops

    x = _CudaStub()
    ids = torch.zeros((2, 3), dtype=torch.int32)
    ops, attr, fn, call = {
        "fused_phase1": (fp_ops, "launches", "fused_phase1_cuda",
                         lambda: fp_ops.fused_phase1(x, x, x, 4)),
        "fused_phase1_quant": (
            fp_ops, "quant_launches", "fused_phase1_quant_cuda",
            lambda: fp_ops.fused_phase1_quant(x, x, x, x, 4)),
        "code_match": (cm_ops, "launches", "code_match_cuda",
                       lambda: cm_ops.code_match(x, x, x)),
        "bucketize": (bk_ops, "launches", "bucketize_cuda",
                      lambda: bk_ops.bucketize(x, "round", 2.0)),
        "rerank_topk": (rk_ops, "launches", "launch",
                        lambda: rk_ops.candidate_scores(x, ids, x)),
    }[name]
    kernel = _YieldingKernel(ops.kernel, fn)
    monkeypatch.setattr(ops, "kernel", kernel)
    monkeypatch.setattr(ops, attr, 0)
    if name == "rerank_topk":
        monkeypatch.setattr(ops, "launches_by_body",
                            dict.fromkeys(ops.launches_by_body, 0))
    n_threads, per = 8, 500
    start = threading.Barrier(n_threads)

    def worker():
        start.wait(timeout=WAIT)
        for _ in range(per):
            call()

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive()
    assert kernel.made == n_threads * per
    assert getattr(ops, attr) == kernel.made * kernel._real.KERNELS_PER_CALL
    if name == "rerank_topk":
        assert ops.launches_by_body == {**dict.fromkeys(
            ops.launches_by_body, 0), "bulk": kernel.made}


def test_launch_record_is_an_op_the_profiler_keeps():
    """Every kernel launches inside ``_build.launch_record``: an op-scope
    record, under which the profiler keeps a launch's CUDA runtime call,
    nested in the range that was open (a group's), on its thread."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import _build

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("repro.cluster.group1"):
            with _build.launch_record("fused_phase1_quant"):
                torch.zeros(2)
    events = {e.name: e for e in prof.events()}
    rec, rng = events["fused_phase1_quant"], events["repro.cluster.group1"]
    assert rec.thread == rng.thread
    assert rng.time_range.start <= rec.time_range.start
    assert rec.time_range.end <= rng.time_range.end
    assert not rec.is_user_annotation and rng.is_user_annotation
