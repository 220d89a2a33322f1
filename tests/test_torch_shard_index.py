"""repro_torch's ShardedVectorIndex at one shard: the segment lifecycle
(ingest, seal, delete, merge, compact) held three ways.

1. To JAX at build time: the leaves of ``build_sharded`` and
   ``from_index`` (codes, posting tables, live, offsets bit-equal; vectors
   to normalize's atol 1e-6), ``max_df`` and ``token_df``.
2. To the reference's own invariant (``tests/test_segments.py``,
   ``tests/test_ingest.py``), applied to the port: a segmented index and a
   flat one (``seal_threshold=None``) give bit-identical ids and scores
   after every stage, for all six engines; sentinels never surface;
   deletes take effect at once; ids stay monotonic.
3. To JAX's flat ``VectorIndex`` over the live rows at ``page >= n_ids``
   (exact-cosine brute force): ids equal through the live-id map, scores
   within atol 1e-5, the rule of ``tests/test_torch_search.py``.

Everything runs on the CPU at the reference tests' sizes (40 docs x 12
features).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import search as jsearch
from repro.dist.shard_index import ShardedVectorIndex as JSharded
from repro.launch.mesh import make_shard_mesh
from repro_torch.core import VectorIndex
from repro_torch.core import encoding as tenc
from repro_torch.core.search import _SENTINEL
from repro_torch.dist.shard_index import DEFAULT_SEAL_THRESHOLD
from repro_torch.dist.shard_index import ShardedVectorIndex as Sharded

ENGINES = ("postings", "codes", "onehot", "codes_pallas", "fused",
           "fused_int8")
N_FEAT = 12
TOL = 1e-5
LEAVES = ("vectors", "codes", "post_docs", "post_codes", "offsets", "live")


def _build(n_docs=40, seed=0):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n_docs, N_FEAT)).astype(np.float32)
    Q = rng.normal(size=(5, N_FEAT)).astype(np.float32)
    return V, Q, rng


def _pair(V, threshold=4):
    return (Sharded.build_sharded(V, seal_threshold=threshold, device="cpu"),
            Sharded.build_sharded(V, seal_threshold=None, device="cpu"))


def _assert_same_results(a, b, queries, ctx, *, ks=(1, 5, 13),
                         pages=(7, 33, None), engines=ENGINES):
    assert a.n_ids == b.n_ids, ctx
    for engine in engines:
        for k in ks:
            for page in pages:
                p = 2 * a.n_ids if page is None else page
                i1, s1 = a.search(queries, k=k, page=p, engine=engine)
                i2, s2 = b.search(queries, k=k, page=p, engine=engine)
                assert torch.equal(i1, i2), (ctx, engine, k, p)
                assert torch.equal(s1, s2), (ctx, engine, k, p)


def _live_rows(sidx):
    """(gids, unit rows) of every live doc, in id order."""
    parts = [(torch.arange(sidx.docs_per_shard, dtype=torch.int32),
              sidx.vectors[0], sidx.live[0])]
    parts += [(s.gids[0], s.vectors[0], s.live[0]) for s in sidx.segments]
    parts.append((sidx.seg_gids[0], sidx.seg_vectors[0], sidx.seg_live[0]))
    g = torch.cat([p[0][p[2]] for p in parts])
    v = torch.cat([p[1][p[2]] for p in parts])
    order = torch.argsort(g)
    return g[order].numpy(), v[order].numpy()


def _assert_matches_jax_flat(sidx, Q, ctx, engines=ENGINES):
    """At page >= n_ids every live doc reaches the exact rescore: the
    answer is JAX's flat index over the live rows, ids mapped."""
    gids, rows = _live_rows(sidx)
    k = min(9, gids.size)
    jidx = jsearch.VectorIndex.build(jnp.asarray(rows))
    ji, js = jidx.search(jnp.asarray(Q), k=k, page=gids.size,
                         engine="codes")
    want_i, want_s = gids[np.asarray(ji)], np.asarray(js)
    for engine in engines:
        ids, s = sidx.search(Q, k=k, page=2 * sidx.n_ids, engine=engine)
        assert np.array_equal(ids.numpy(), want_i), (ctx, engine)
        np.testing.assert_allclose(s.numpy(), want_s, atol=TOL, rtol=0,
                                   err_msg=str((ctx, engine)))


# ------------------------------------------------------- lifecycle parity
@pytest.mark.parametrize("engine", ENGINES)
def test_lifecycle_parity_segmented_vs_flat(engine):
    """THE invariant: the same history on a segmented index
    (seal_threshold=4) and a flat one gives bit-identical ids and scores
    at every (k, page) after every stage -- ingest that seals, deletes in
    base, sealed and active rows, a partial merge (and the merge is
    invisible), a compact."""
    V, Q, rng = _build()
    seg, flat = _pair(V)
    kw = dict(engines=(engine,))
    _assert_same_results(seg, flat, Q, "built", **kw)
    for step in range(3):                       # ingest: seals twice
        W = rng.normal(size=(5, N_FEAT)).astype(np.float32)
        seg, flat = seg.add_documents(W), flat.add_documents(W)
        _assert_same_results(seg, flat, Q, ("ingest", step), **kw)
    assert seg.n_segments >= 2 and flat.n_segments == 0

    victims = [2, 3, 41, 42, 47, 54]            # base + sealed + active
    seg, flat = seg.delete(victims), flat.delete(victims)
    _assert_same_results(seg, flat, Q, "deleted", **kw)

    merged = seg.merge_segments(0, 2)
    assert merged.n_segments == seg.n_segments - 1
    _assert_same_results(merged, flat, Q, "merged", **kw)
    _assert_same_results(merged, seg, Q, "merge is invisible", **kw)

    seg, flat = merged.compact(), flat.compact()
    _assert_same_results(seg, flat, Q, "compacted", **kw)
    assert seg.n_segments == 0 and seg.tombstone_ratio == 0.0


def _page_scores(sidx, Q, engine, page):
    """{(query, gid): the page's exact cosine} over the live docs of the
    phase-1 page of size ``page``."""
    from repro_torch.core.rerank import normalize
    from repro_torch.dist.shard_index import _gather_merge

    q = normalize(torch.from_numpy(Q))
    qcodes = sidx.encoder.encode(q)
    mask = torch.ones(qcodes.shape, dtype=torch.bool)
    page_loc = min(page, sidx.n_ids, sidx.docs_per_shard + sidx.seg_capacity
                   + sum(s.width for s in sidx.segments))
    gid, s2, _ = _gather_merge(sidx._shard_pages(
        q, qcodes, mask, engine, "idf", sidx.docs_per_shard, page_loc))
    return {(i, int(g)): float(v) for i in range(len(Q))
            for g, v in zip(gid[i].tolist(), s2[i].tolist())
            if v != float("-inf")}


@pytest.mark.parametrize("engine", ENGINES)
def test_page_scores_do_not_depend_on_layout(engine):
    """Each live doc's re-rank score on the page has the same bits in a
    segmented index, a flat one and after a merge, on pages of any size:
    the page is scored per row in a fixed order (``tree_dot``), not by a
    product whose reduction order a library picks by shape."""
    V, Q, rng = _build()
    seg, flat = _pair(V)
    for _ in range(3):
        W = rng.normal(size=(5, N_FEAT)).astype(np.float32)
        seg, flat = seg.add_documents(W), flat.add_documents(W)
    seg, flat = seg.delete([2, 41, 47]), flat.delete([2, 41, 47])
    want = _page_scores(flat, Q, engine, flat.n_ids)
    assert len(want) == len(Q) * (flat.n_ids - 3)
    for other in (seg, seg.merge_segments(0, 2), flat):
        for page in (1, 7, 13, 33, other.n_ids):
            got = _page_scores(other, Q, engine, page)
            assert got and all(want[key] == v for key, v in got.items()), \
                page


@pytest.mark.parametrize("scorer", ["code_match", "fused_phase1_quant",
                                    "tree_dot"])
def test_row_scores_do_not_depend_on_table_width(scorer):
    """The plain versions that score generations on the CPU give a row the
    same bits in a table of any width, at any offset: what lets a row
    score alike in a 5-row segment and a 600-row flat buffer."""
    from repro_torch.core.quantize import quantize_table
    from repro_torch.core.rerank import tree_dot
    from repro_torch.kernels.code_match import ops as cm_ops
    from repro_torch.kernels.fused_phase1 import ops as fp_ops

    rng = np.random.default_rng(5)
    n, Q = 48, 7
    V = torch.from_numpy(rng.normal(size=(600, n)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(Q, n)).astype(np.float32))
    if scorer == "code_match":
        D = torch.from_numpy(rng.integers(-3, 3, size=(600, n))
                             .astype(np.int8))
        qc = D[:Q].clone()
        w = torch.from_numpy(rng.random((Q, n)).astype(np.float32))
        score = lambda lo, hi: cm_ops.code_match(D[lo:hi], qc, w)
    elif scorer == "fused_phase1_quant":
        t = quantize_table(V)

        def score(lo, hi):
            s, i = fp_ops.fused_phase1_quant(t.codes[lo:hi], t.scale[lo:hi],
                                             t.zero[lo:hi], q, page=hi - lo)
            out = torch.empty_like(s)
            out.scatter_(1, i.long(), s)
            return out
    else:
        score = lambda lo, hi: tree_dot(V[None, lo:hi], q[:, None, :])
    full = score(0, 600)
    for lo, hi in ((0, 5), (3, 9), (17, 50), (100, 613), (40, 41)):
        hi = min(hi, 600)
        assert torch.equal(score(lo, hi), full[:, lo:hi]), (lo, hi)


def test_lifecycle_matches_jax_flat_index_over_live_rows():
    """At every stage, page >= n_ids: every engine answers what JAX's flat
    VectorIndex over the live rows answers."""
    V, Q, rng = _build(seed=7)
    seg, _ = _pair(V)
    _assert_matches_jax_flat(seg, Q, "built")
    for step in range(3):
        seg = seg.add_documents(rng.normal(size=(5, N_FEAT))
                                .astype(np.float32))
        _assert_matches_jax_flat(seg, Q, ("ingest", step))
    seg = seg.delete([2, 3, 41, 42, 47, 54])
    _assert_matches_jax_flat(seg, Q, "deleted")
    seg = seg.merge_segments(0, 2)
    _assert_matches_jax_flat(seg, Q, "merged")
    seg = seg.compact()
    _assert_matches_jax_flat(seg, Q, "compacted")


def test_seal_structure_is_deterministic():
    """The buffer seals the moment it reaches the threshold, and the
    sealed generation holds the right rows and ids."""
    V, _, rng = _build(n_docs=20)
    sidx = Sharded.build_sharded(V, seal_threshold=4, device="cpu")
    sidx = sidx.add_documents(rng.normal(size=(5, N_FEAT))
                              .astype(np.float32))
    assert sidx.n_segments == 1 and sidx.n_active == 0
    assert sidx.segments[0].n_rows == 5 and sidx.seg_base == 5
    g = sidx.segments[0].gids.numpy().ravel()
    assert sorted(g[g >= 0]) == [20, 21, 22, 23, 24]
    assert sidx.segments[0].width == 5 and sidx.seg_capacity == 0
    sidx = sidx.add_documents(rng.normal(size=(3, N_FEAT))
                              .astype(np.float32))
    assert sidx.n_segments == 1 and sidx.n_active == 3   # below threshold
    sidx = sidx.add_documents(rng.normal(size=(2, N_FEAT))
                              .astype(np.float32))
    assert sidx.n_segments == 2 and sidx.n_active == 0   # 3 + 2 sealed
    assert sidx.segments[1].n_rows == 5
    assert sidx.n_ids == 30 and sidx.segment_rows == 10
    assert sidx.shard_populations.tolist() == [30]


def test_capacity_ladder_and_default_threshold():
    """The active buffer grows to max(need, 2G, 8) slots; a fresh index
    seals at 256 rows."""
    V, _, rng = _build(n_docs=10)
    sidx = Sharded.build_sharded(V, seal_threshold=None, device="cpu")
    assert Sharded.build_sharded(V, device="cpu").seal_threshold \
        == DEFAULT_SEAL_THRESHOLD == 256
    caps = []
    for m in (2, 5, 1, 9, 3, 20):
        sidx = sidx.add_documents(rng.normal(size=(m, N_FEAT))
                                  .astype(np.float32))
        caps.append(sidx.seg_capacity)
    assert caps == [8, 8, 8, 17, 34, 68]
    assert sidx.n_active == 40 and sidx.n_segments == 0


def test_segment_tombstone_accounting_and_exact_df():
    """Deletes land in the right generation's tombstones and keep df
    exact: token_df equals the flat index's through sealed and active
    deletes, and a compact changes none of it."""
    V, Q, rng = _build(n_docs=20)
    seg, flat = _pair(V)
    W = rng.normal(size=(5, N_FEAT)).astype(np.float32)
    seg, flat = seg.add_documents(W), flat.add_documents(W)
    W2 = rng.normal(size=(2, N_FEAT)).astype(np.float32)
    seg, flat = seg.add_documents(W2), flat.add_documents(W2)
    assert seg.n_segments == 1 and seg.n_active == 2
    seg, flat = seg.delete([5, 21, 26]), flat.delete([5, 21, 26])
    assert seg.segments[0].tombstones == 1
    assert seg.segments[0].deleted_ratio == pytest.approx(1 / 5)
    assert seg.active_tombstones == 1
    assert seg.n_tombstones == flat.n_tombstones == 3
    assert seg.tombstone_ratio == pytest.approx(3 / 27)
    df = seg.token_df(Q)
    assert df.dtype == torch.int32 and torch.equal(df, flat.token_df(Q))
    assert torch.equal(df, seg.compact().token_df(Q))
    # a second delete of a dead id counts nothing
    again = seg.delete([5, 21])
    assert again.n_tombstones == 3 and again.segments[0].tombstones == 1
    _assert_same_results(seg, flat, Q, "df after segment deletes")


def test_merge_segments_reclaims_and_validates():
    V, Q, rng = _build(n_docs=16)
    sidx = Sharded.build_sharded(V, seal_threshold=4, device="cpu")
    with pytest.raises(ValueError, match="no sealed segments"):
        sidx.merge_segments()
    for _ in range(3):
        sidx = sidx.add_documents(rng.normal(size=(4, N_FEAT))
                                  .astype(np.float32))
    assert sidx.n_segments == 3
    sidx = sidx.delete([17, 18, 21])            # 2 dead in seg0, 1 in seg1
    for start, count in ((2, 2), (-1, 1), (0, 0)):
        with pytest.raises(ValueError, match="invalid merge range"):
            sidx.merge_segments(start, count)
    merged = sidx.merge_segments(0, 2)
    assert merged.n_segments == 2
    assert merged.segments[0].n_rows == 5       # 8 rows - 3 tombstones
    assert merged.segments[0].tombstones == 0
    assert merged.segments[1].n_rows == sidx.segments[2].n_rows
    assert merged.n_reclaimed == sidx.n_reclaimed + 3
    assert merged.n_ids == sidx.n_ids and merged.n_tombstones == 0
    g = merged.segments[0].gids.numpy().ravel()
    assert g.tolist() == [16, 19, 20, 22, 23]   # id order
    _assert_same_results(merged, sidx, Q, "merge preserves results")


def test_merge_of_all_dead_segments_drops_them():
    V, Q, rng = _build(n_docs=16)
    sidx = Sharded.build_sharded(V, seal_threshold=4, device="cpu")
    sidx = sidx.add_documents(rng.normal(size=(4, N_FEAT))
                              .astype(np.float32))
    sidx = sidx.delete([16, 17, 18, 19])
    merged = sidx.merge_segments()
    assert merged.n_segments == 0 and merged.n_reclaimed == 4
    assert merged.n_tombstones == 0
    _assert_same_results(merged, sidx, Q, "all-dead merge",
                         pages=(7, None))
    # k = n_ids = 20 > the 16 slots left: the last 4 slots cannot be filled
    ids, scores = merged.search(Q, k=20, page=100, engine="fused")
    assert ids.shape == (5, 20) and (ids[:, 16:] == -1).all()
    assert torch.isneginf(scores[:, 16:]).all()
    assert torch.equal(torch.sort(ids[:, :16], 1).values,
                       torch.arange(16, dtype=torch.int32).expand(5, -1))


# ------------------------------------------------------------ ingest story
_KP_GRID = [(1, 1), (3, 8), (10, 23), (10, 10_000), (64, 64)]


@pytest.mark.parametrize("merge", ["gather", "stream"])
@pytest.mark.parametrize("engine", ENGINES)
def test_sentinel_never_surfaces_through_ingest_lifecycle(engine, merge):
    """No dead, padded or sentinel id in any result cell, before and after
    add_documents, delete and compact; -inf slots are id -1."""
    rng = np.random.default_rng(0)
    V = rng.normal(size=(23, N_FEAT)).astype(np.float32)
    W = rng.normal(size=(9, N_FEAT)).astype(np.float32)
    Q = np.concatenate([V[:3], W[:3]])

    def check(sidx, live):
        live = set(live)
        for k, page in _KP_GRID:
            ids, scores = sidx.search(Q, k=k, page=page, engine=engine,
                                      merge=merge)
            ids, scores = ids.numpy(), scores.numpy()
            dead = ids == -1
            assert (np.isneginf(scores) == dead).all(), (k, page)
            assert all(i in live for i in ids[~dead].ravel()), (k, page)
            want = min(k, len(live))
            assert (~dead).sum(axis=1).tolist() == [want] * len(Q)

    sidx = Sharded.build_sharded(V, device="cpu")
    check(sidx, range(23))
    grown = sidx.add_documents(W)                    # ids 23..31
    assert grown.n_ids == 32 and grown.seg_capacity == 9
    check(grown, range(32))
    pruned = grown.delete([0, 7, 25, 31])
    check(pruned, set(range(32)) - {0, 7, 25, 31})
    packed = pruned.compact()
    assert packed.n_docs == 32 and packed.n_appended == 0
    assert packed.seg_capacity == 0
    check(packed, set(range(32)) - {0, 7, 25, 31})
    sentinel = _SENTINEL[packed.codes.dtype]
    assert (packed.codes[0, [0, 7, 25, 31]] == sentinel).all()


def test_appended_docs_are_searchable_and_exact():
    """A hot-added doc is its own top hit (score ~1), and a compacted
    index returns the same result set."""
    rng = np.random.default_rng(1)
    V = rng.normal(size=(23, N_FEAT)).astype(np.float32)
    W = rng.normal(size=(9, N_FEAT)).astype(np.float32)
    grown = Sharded.build_sharded(V, device="cpu").add_documents(W)
    ids, scores = grown.search(W, k=3, page=1_000, engine="codes")
    assert (ids[:, 0].numpy() == np.arange(23, 32)).all()
    np.testing.assert_allclose(scores[:, 0].numpy(), 1.0, rtol=1e-5)
    packed = grown.compact()
    ids2, _ = packed.search(W, k=32, page=1_000, engine="postings")
    idsf, _ = grown.search(W, k=32, page=1_000, engine="postings")
    assert np.array_equal(np.sort(ids2.numpy(), 1), np.sort(idsf.numpy(), 1))


@pytest.mark.parametrize("engine", ENGINES)
def test_delete_is_immediate_for_every_engine(engine):
    rng = np.random.default_rng(2)
    V = rng.normal(size=(23, N_FEAT)).astype(np.float32)
    sidx = Sharded.build_sharded(V, device="cpu")
    ids, _ = sidx.search(V[5], k=1, page=100, engine=engine)
    assert int(ids[0, 0]) == 5
    pruned = sidx.delete([5])
    ids, _ = pruned.search(V[5], k=23, page=100, engine=engine)
    assert 5 not in ids.numpy()
    assert pruned.delete([5]).n_tombstones == 1   # dead again: a no-op
    with pytest.raises(ValueError, match="ids must be in"):
        pruned.delete([23])
    with pytest.raises(ValueError, match="ids must be in"):
        pruned.delete([-1])
    assert pruned.delete([]) is pruned


def test_gids_stay_monotonic_across_delete():
    rng = np.random.default_rng(3)
    V = rng.normal(size=(23, N_FEAT)).astype(np.float32)
    W = rng.normal(size=(9, N_FEAT)).astype(np.float32)
    sidx = Sharded.build_sharded(V[:5], device="cpu")
    grown = sidx.add_documents(W[:2]).delete([5, 6]).add_documents(W[2:4])
    assert grown.n_ids == 9
    ids, _ = grown.search(W[2:4], k=2, page=20, engine="codes")
    assert (ids[:, 0].numpy() == [7, 8]).all()


def test_add_documents_validates_and_noops():
    V, _, _ = _build(n_docs=23)
    sidx = Sharded.build_sharded(V, device="cpu")
    assert sidx.add_documents(np.zeros((0, N_FEAT), np.float32)) is sidx
    with pytest.raises(ValueError, match="feature"):
        sidx.add_documents(np.zeros((2, 5), np.float32))
    with pytest.raises(ValueError, match="unknown merge transport"):
        sidx.search(V[:1], merge="ring")


def test_donated_ingest_writes_in_place_and_matches():
    """donate=True writes a batch that fits into the active buffer's own
    tensors and answers what a copying ingest answers; a growth batch
    never writes into the old buffer."""
    V, Q, rng = _build()
    base = Sharded.build_sharded(V, seal_threshold=None, device="cpu")
    a = base.add_documents(rng.normal(size=(3, N_FEAT)).astype(np.float32))
    assert a.seg_capacity == 8
    W = rng.normal(size=(4, N_FEAT)).astype(np.float32)
    copied = a.add_documents(W)
    assert copied.seg_vectors.data_ptr() != a.seg_vectors.data_ptr()
    before = a.seg_live.clone()
    donated = a.add_documents(W, donate=True)
    for name in ("seg_vectors", "seg_codes", "seg_gids", "seg_live"):
        assert getattr(donated, name).data_ptr() == \
            getattr(a, name).data_ptr(), name
    assert not torch.equal(before, a.seg_live)    # a's buffer was written
    _assert_same_results(donated, copied, Q, "donated", ks=(5,),
                         pages=(33, None))
    grown = donated.add_documents(rng.normal(size=(9, N_FEAT))
                                  .astype(np.float32), donate=True)
    assert grown.seg_capacity == 16
    assert grown.seg_vectors.data_ptr() != donated.seg_vectors.data_ptr()


def test_max_postings_auto_is_exact():
    """max_postings="auto" sizes the window from max_df: the same answer
    as the exact window, and max_df counts live docs only."""
    V, Q, rng = _build()
    sidx = Sharded.build_sharded(V, device="cpu").add_documents(
        rng.normal(size=(6, N_FEAT)).astype(np.float32))
    for s in (sidx, sidx.delete([0, 1, 2, 41])):
        want = s.search(Q, k=5, page=20, engine="postings")
        got = s.search(Q, k=5, page=20, engine="postings",
                       max_postings="auto")
        assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
        pc = s.post_codes[0].numpy()
        sentinel = _SENTINEL[s.codes.dtype]
        longest = max(int(np.max(np.unique(r[r != sentinel],
                                           return_counts=True)[1]))
                      for r in pc)
        assert s.max_df == longest


def test_vector_index_shard_shares_tensors():
    V, Q, _ = _build()
    idx = VectorIndex.build(V, device="cpu")
    idx.quantized                                   # cached int8 table
    sidx = idx.shard(seal_threshold=8)
    assert sidx.seal_threshold == 8 and sidx.n_docs == idx.n_docs
    assert sidx.vectors.data_ptr() == idx.vectors.data_ptr()
    assert sidx.codes.data_ptr() == idx.codes.data_ptr()
    assert sidx.post_docs.data_ptr() == idx.postings.post_docs.data_ptr()
    assert sidx._quant_base()[0].data_ptr() == idx.quantized.codes.data_ptr()
    for engine in ENGINES:
        i1, s1 = idx.search(Q, k=5, page=2 * idx.n_docs, engine=engine)
        i2, s2 = sidx.search(Q, k=5, page=2 * idx.n_docs, engine=engine)
        assert torch.equal(i1, i2), engine
        np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=TOL, rtol=0)


# ------------------------------------------------------ against JAX leaves
ENCODERS = [  # (JAX encoder, the port's same encoder)
    (jenc.RoundingEncoder(2), tenc.RoundingEncoder(2)),
    (jenc.CombinedEncoder(jenc.RoundingEncoder(1), jenc.IntervalEncoder(0.1)),
     tenc.CombinedEncoder(tenc.RoundingEncoder(1), tenc.IntervalEncoder(0.1))),
]


@pytest.fixture(scope="module", params=ENCODERS,
                ids=lambda e: e[0].scheme_id)
def jax_pair(request):
    je, te = request.param
    rng = np.random.default_rng(11)
    V = rng.normal(size=(40, N_FEAT)).astype(np.float32)
    live = rng.random(40) < 0.8
    return V, live, je, te


def _assert_leaves_equal(port, jax_index):
    for name in LEAVES:
        got = getattr(port, name).numpy()
        want = np.asarray(getattr(jax_index, name))
        assert got.shape == want.shape, name
        if name == "vectors":
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                name


@pytest.mark.parametrize("index_best", [None, 5])
@pytest.mark.parametrize("with_live", [False, True])
def test_build_sharded_leaves_match_jax(jax_pair, index_best, with_live):
    V, live, je, te = jax_pair
    lv = live if with_live else None
    want = JSharded.build_sharded(V, make_shard_mesh(1), encoder=je,
                                  index_best=index_best, live=lv)
    got = Sharded.build_sharded(V, encoder=te, index_best=index_best,
                                live=lv, device="cpu")
    _assert_leaves_equal(got, want)
    assert got.n_docs == want.n_docs and got.n_ids == want.n_ids
    assert got.seg_capacity == want.seg_capacity == 0


def test_from_index_leaves_match_jax(jax_pair):
    V, _, je, te = jax_pair
    jidx = jsearch.VectorIndex.build(jnp.asarray(V), encoder=je)
    want = JSharded.from_index(jidx, make_shard_mesh(1))
    tidx = VectorIndex.build(V, encoder=te, device="cpu")
    got = Sharded.from_index(tidx)
    _assert_leaves_equal(got, want)


def test_max_df_and_token_df_match_jax(jax_pair):
    V, live, je, te = jax_pair
    Q = np.random.default_rng(12).normal(size=(6, N_FEAT)).astype(np.float32)
    for lv in (None, live):
        want = JSharded.build_sharded(V, make_shard_mesh(1), encoder=je,
                                      live=lv)
        got = Sharded.build_sharded(V, encoder=te, live=lv, device="cpu")
        assert got.max_df == want.max_df
        assert np.array_equal(got.token_df(Q).numpy(),
                              np.asarray(want.token_df(Q)))
