"""repro_torch's ShardedVectorIndex at S doc-shards x R replica groups,
held to the JAX package three ways.

1. To the reference's leaves: ``build_sharded`` and ``from_index`` at 4 and
   4 x 2 (ragged 123 docs and even 120, ``index_best`` on and off, and with
   a ``live`` mask), ``max_df`` and ``token_df``, and the leaves its
   ``restore`` rebuilds from the port's 4-shard commit.  The reference's
   layouts need a mesh of 8 CPU devices, so they are built in ONE
   subprocess that sets ``XLA_FLAGS`` before JAX starts.
2. To answers: at ``page >= n_docs`` every engine, both transports and
   both weightings answer bit for bit as the port's one-shard index and
   with JAX's flat ``VectorIndex.search``'s ids (scores within 1e-5); at
   ``page < n_docs`` the ids equal a per-shard protocol composed from the
   reference's pure functions (``phase1_engine_scores``, ``df_lookup``,
   ``idf_weights``, ``match_scores``, ``quantize_rows``), on the queries
   whose answer no near-tie decides.
3. To the reference's invariants applied to the port: replica
   round-robin, ``live_groups`` and ``replica_group`` are bit-invisible,
   the ingest lifecycle at 4 shards is segmented = flat = one shard, the
   serving engine equals the index, and commits move between layouts and
   packages.

Everything runs on the CPU at the reference tests' sizes.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import search as jsearch
from repro.core.postings import Postings as JPostings
from repro.core.postings import build_postings as jbuild_postings
from repro.core.postings import df_lookup as jdf_lookup
from repro.core.postings import idf_weights as jidf_weights
from repro.core.quantize import quantize_rows as jquantize_rows
from repro.core.rerank import normalize as jnormalize
from repro.dist.shard_index import ShardedVectorIndex as JSharded
from repro.kernels.fused_phase1.ref import match_scores as jmatch_scores
from repro.launch.mesh import make_shard_mesh as jmesh
from repro.obs.stats import index_stats as jindex_stats
from repro.store import snapshot as jsnap
from repro_torch import interop
from repro_torch.core import RoundingEncoder, TrimFilter, VectorIndex
from repro_torch.dist import DATA_AXIS, REPLICA_AXIS, ShardedVectorIndex
from repro_torch.launch import ShardMesh, make_shard_mesh
from repro_torch.obs.stats import index_stats
from repro_torch.serve import BatchedSearchEngine
from repro_torch.store import Store, recover, restore, write_commit
from repro_torch.store.snapshot import latest_commit

ENGINES = ("postings", "codes", "onehot", "codes_pallas", "fused",
           "fused_int8")
LAYOUTS = ((4, 1), (4, 2))
N_FEAT = 16
TOL = 1e-5
LEAVES = ("vectors", "codes", "post_docs", "post_codes", "offsets", "live")
ACTIVE = ("seg_vectors", "seg_codes", "seg_gids", "seg_live")
SEG_LEAVES = ("vectors", "codes", "gids", "live", "post_docs", "post_codes")
_REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tensors are tiny: one intra-op thread a worker keeps the
    parallel suite's workers from oversubscribing the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(S, R=1):
    return make_shard_mesh(S, R, device="cpu")


def _data(n_docs, seed=0, n_queries=7):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n_docs, N_FEAT)).astype(np.float32)
    Q = rng.normal(size=(n_queries, N_FEAT)).astype(np.float32)
    return V, Q


def _same(a, b, ctx):
    assert torch.equal(a[0], b[0]), ctx
    assert torch.equal(a[1], b[1]), ctx


def _rows(seed, m):
    return np.random.default_rng(seed).normal(
        size=(m, N_FEAT)).astype(np.float32)


def _lifecycle(index, seed=3):
    """On 123 base docs: ingest that seals raggedly at a threshold of 4 (5
    rows, 5 rows, 3 left active), deletes in the base of three shards,
    two sealed segments and the active buffer, a merge of the two
    segments (where there are), 3 more rows that seal; -> [(stage,
    index)]."""
    out = [("built", index)]
    for b, m in enumerate((5, 5, 3)):
        index = index.add_documents(_rows(seed + b, m))
        out.append((f"ingest{b}", index))
    index = index.delete([2, 3, 60, 100, 124, 129, 134, 135])
    out.append(("deleted", index))
    if index.n_segments >= 2:
        index = index.merge_segments(0, 2)
    out.append(("merged", index))
    index = index.add_documents(_rows(seed + 9, 3))
    out.append(("tail", index))
    return out


def _jax_writer(idx):
    """What the reference's ``write_commit`` reads of an index, from the
    port's (CPU) leaves, with the reference's encoder of the same scheme:
    the reference's writer writing the port's S-shard layout."""
    names = ("n_shards", "docs_per_shard", "n_features", "n_docs",
             "n_active", "n_appended", "seg_base", "active_tombstones",
             "seal_threshold", "seg_capacity", "shard_tombstones",
             "index_best") + LEAVES + ACTIVE
    ns = types.SimpleNamespace(**{n: getattr(idx, n) for n in names})
    ns.segments = idx.segments
    ns.encoder = jenc.RoundingEncoder(idx.encoder.precision)
    return ns


# ------------------------------------------------------------- reference
_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax.numpy as jnp, numpy as np
from repro.core import VectorIndex
from repro.dist.shard_index import ShardedVectorIndex as J
from repro.launch.mesh import make_shard_mesh
from repro.store import snapshot as js

inp = dict(np.load(sys.argv[1]))
out = {}
meshes = {"4x1": make_shard_mesh(4), "4x2": make_shard_mesh(4, 2)}
NAMES = ("vectors", "codes", "post_docs", "post_codes", "offsets", "live")

def put(key, idx, Q, df=True):
    for n in NAMES:
        out[f"{key}/{n}"] = np.asarray(getattr(idx, n))
    if df:
        out[f"{key}/token_df"] = np.asarray(idx.token_df(jnp.asarray(Q)))
        out[f"{key}/max_df"] = np.asarray(idx.max_df)

Q = inp["Q"]
for n in (123, 120):
    V = inp[f"V{n}"]
    for ib in (None, 5):
        for lay, mesh in meshes.items():
            key = f"{n}/{ib}/{lay}"
            put(f"build/{key}", J.build_sharded(jnp.asarray(V), mesh,
                                                index_best=ib), Q)
            put(f"from_index/{key}", J.from_index(
                VectorIndex.build(jnp.asarray(V), index_best=ib), mesh), Q,
                df=False)
    live = inp[f"live{n}"]
    put(f"live/{n}", J.build_sharded(jnp.asarray(V), meshes["4x1"],
                                     live=jnp.asarray(live)), Q)
    # a reference 4-shard commit of the base
    js.write_commit(os.path.join(sys.argv[3], f"ref{n}"),
                    J.build_sharded(jnp.asarray(V), meshes["4x1"]), 5)
# the port's 4-shard commits, restored by the reference on 4 devices
for name in sorted(os.listdir(sys.argv[2])):
    rec = js.restore(js.latest_commit(os.path.join(sys.argv[2], name)),
                     meshes["4x1"])
    put(f"restore/{name}", rec, Q)
    for n in ("seg_vectors", "seg_codes", "seg_gids", "seg_live"):
        out[f"restore/{name}/{n}"] = np.asarray(getattr(rec, n))
    for i, s in enumerate(rec.segments):
        for n in ("vectors", "codes", "gids", "live", "post_docs",
                  "post_codes"):
            out[f"restore/{name}/seg{i}/{n}"] = np.asarray(getattr(s, n))
    out[f"restore/{name}/n_segments"] = np.asarray(len(rec.segments))
    out[f"restore/{name}/shard_tombstones"] = np.asarray(
        rec.shard_tombstones or (0,) * rec.n_shards)
np.savez(sys.argv[4], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's leaves at 4 and 4 x 2, its restore of the port's
    4-shard commits, and its own 4-shard commits; one subprocess."""
    tmp = tmp_path_factory.mktemp("ref")
    V123, Q = _data(123)
    V120, _ = _data(120)
    rng = np.random.default_rng(11)
    inputs = {"V123": V123, "V120": V120, "Q": Q}
    for n in (123, 120):
        inputs[f"live{n}"] = rng.random(n) > 0.3
    np.savez(tmp / "in.npz", **inputs)
    port_dirs, ref_dirs = tmp / "port", tmp / "jax"
    port_dirs.mkdir()
    ref_dirs.mkdir()
    stages = dict(_lifecycle(ShardedVectorIndex.build_sharded(
        V123, seal_threshold=4, mesh=_mesh(4))))
    for name in ("built", "deleted", "tail"):
        write_commit(str(port_dirs / name), stages[name], seq=7)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp / "in.npz"),
         str(port_dirs), str(ref_dirs), str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, cwd=_REPO, timeout=600)
    assert "OK" in run.stdout, run.stdout + run.stderr
    out = dict(np.load(tmp / "out.npz"))
    return types.SimpleNamespace(out=out, inputs=inputs, stages=stages,
                                 ref_dirs=ref_dirs)


def _assert_leaves(port, ref, key, ctx, vec_atol=1e-6):
    """Leaves equal to the reference's under ``key`` (vectors within
    ``vec_atol``), and token_df and max_df where it took them."""
    for n in LEAVES:
        got, want = getattr(port, n).numpy(), ref.out[f"{key}/{n}"]
        assert got.shape == want.shape, (ctx, n)
        if n == "vectors":       # normalize: torch and XLA, 1e-6 apart
            np.testing.assert_allclose(got, want, atol=vec_atol, rtol=0,
                                       err_msg=str((ctx, n)))
        else:
            assert np.array_equal(got, want), (ctx, n)
    if f"{key}/token_df" in ref.out:
        assert np.array_equal(port.token_df(ref.inputs["Q"]).numpy(),
                              ref.out[f"{key}/token_df"]), ctx
        assert port.max_df == int(ref.out[f"{key}/max_df"]), ctx


# ------------------------------------------------------------------ mesh
def test_make_shard_mesh_layout_and_validation():
    m = make_shard_mesh(4, 2, device="cpu")
    assert m.axis_names == (DATA_AXIS, REPLICA_AXIS) == ("data", "replica")
    assert m.shape == {"data": 4, "replica": 2}
    assert (m.n_shards, m.n_replicas) == (4, 2)
    assert len(m.devices) == 4 and all(len(r) == 2 for r in m.devices)
    assert m.device == torch.device("cpu")
    col = m.column(1)
    assert col.axis_names == ("data",) and col.shape == {"data": 4,
                                                         "replica": 1}
    assert make_shard_mesh(3).device == torch.device("cuda")
    with pytest.raises(ValueError):
        make_shard_mesh(0)
    with pytest.raises(ValueError):
        m.column(2)
    spread = ShardMesh(((torch.device("cpu"),), (torch.device("meta"),)))
    with pytest.raises(ValueError, match="spans 2 devices"):
        spread.device
    V, _ = _data(20)
    with pytest.raises(ValueError, match="not both"):
        ShardedVectorIndex.build_sharded(V, mesh=_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="more shards"):
        ShardedVectorIndex.build_sharded(V[:3], mesh=_mesh(4))
    with pytest.raises(ValueError, match="the index is on cpu"):
        VectorIndex.build(V, device="cpu").shard(make_shard_mesh(2))


# ---------------------------------------------------------------- leaves
@pytest.mark.parametrize("layout", ["4x1", "4x2"])
@pytest.mark.parametrize("index_best", [None, 5])
@pytest.mark.parametrize("n_docs", [123, 120])
def test_leaves_match_reference(ref, n_docs, index_best, layout):
    """build_sharded and from_index at 4 and 4 x 2 against the
    reference's: codes, posting tables, offsets and live bit-equal,
    vectors within normalize's 1e-6, and build_sharded's token_df and
    max_df equal."""
    V = ref.inputs[f"V{n_docs}"]
    mesh = _mesh(4, int(layout[-1]))
    key = f"{n_docs}/{index_best}/{layout}"
    built = ShardedVectorIndex.build_sharded(V, index_best=index_best,
                                             mesh=mesh)
    _assert_leaves(built, ref, f"build/{key}", ("build", key))
    flat = VectorIndex.build(V, index_best=index_best, device="cpu")
    sharded = flat.shard(mesh)
    _assert_leaves(sharded, ref, f"from_index/{key}", ("from_index", key))
    assert (sharded.n_shards, sharded.n_replicas) == (4, int(layout[-1]))


@pytest.mark.parametrize("n_docs", [123, 120])
def test_live_mask_leaves_match_reference(ref, n_docs):
    V, live = ref.inputs[f"V{n_docs}"], ref.inputs[f"live{n_docs}"]
    got = ShardedVectorIndex.build_sharded(V, live=live, mesh=_mesh(4))
    _assert_leaves(got, ref, f"live/{n_docs}", ("live", n_docs))


def test_from_index_views_flat_tensors_and_groups_share():
    """Where the rows split evenly, the shards are views of the flat
    index's vectors, codes and int8 table; replica groups and
    ``replica_group`` share every tensor; a ragged split pads copies."""
    V, Q = _data(120)
    flat = VectorIndex.build(V, device="cpu")
    flat.quantized
    s = flat.shard(_mesh(4, 2))
    assert s.vectors.data_ptr() == flat.vectors.data_ptr()
    assert s.codes.data_ptr() == flat.codes.data_ptr()
    q8 = s._quant_base()
    assert q8[0].data_ptr() == flat.quantized.codes.data_ptr()
    assert q8[1].data_ptr() == flat.quantized.scale.data_ptr()
    g = s.replica_group(1)
    assert g.n_replicas == 1 and g.mesh.axis_names == ("data",)
    for n in LEAVES + ACTIVE:
        assert getattr(g, n) is getattr(s, n), n
    assert g._quant_base() is q8
    ragged = VectorIndex.build(V[:119], device="cpu").shard(_mesh(4))
    assert ragged.docs_per_shard == 30 and not bool(ragged.live[3, -1])


# ------------------------------------------------------------ page >= n
@pytest.mark.parametrize("engine", ENGINES)
def test_full_page_bit_equal_to_one_shard_and_jax_flat(engine):
    """page >= n_docs: 4 and 4 x 2, both transports, both weightings ->
    the port's one-shard answer bit for bit, and JAX's flat index's ids
    with scores within 1e-5."""
    for n_docs in (123, 120):
        V, Q = _data(n_docs)
        one = VectorIndex.build(V, device="cpu").shard()
        jidx = jsearch.VectorIndex.build(jnp.asarray(V))
        for weighting in ("idf", "count"):
            want = one.search(Q, k=10, page=2 * n_docs, engine=engine,
                              weighting=weighting)
            ji, js = jidx.search(jnp.asarray(Q), k=10, page=2 * n_docs,
                                 engine=engine, weighting=weighting)
            assert np.array_equal(want[0].numpy(), np.asarray(ji))
            np.testing.assert_allclose(want[1].numpy(), np.asarray(js),
                                       atol=TOL, rtol=0)
            for S, R in LAYOUTS:
                sidx = ShardedVectorIndex.build_sharded(V, mesh=_mesh(S, R))
                for merge in ("gather", "stream"):
                    _same(sidx.search(Q, k=10, page=2 * n_docs,
                                      engine=engine, weighting=weighting,
                                      merge=merge), want,
                          (n_docs, weighting, S, R, merge))


# ------------------------------------------------------------ page < n
def _oracle(V, Q, engine, S, page, k, precision):
    """The reference's per-shard protocol from its pure functions ->
    (ids (Q, k), exact cosines (Q, k), near-tie mask (Q,)): phase 1 per
    contiguous shard with idf over the summed df, each shard's top page
    (stable), exact cosines of the pages, the shard-major join's top k."""
    n = V.shape[0]
    dp = -(-n // S)
    enc = jenc.RoundingEncoder(precision)
    v = np.asarray(jnormalize(jnp.asarray(V)))
    codes = np.asarray(enc.encode(jnp.asarray(v)))
    q = jnormalize(jnp.asarray(Q))
    qc = enc.encode(q)
    shards = [(lo, min(lo + dp, n)) for lo in range(0, n, dp)]
    posts = [jbuild_postings(jnp.asarray(codes[lo:hi])) for lo, hi in shards]
    df = sum(jdf_lookup(p, qc) for p in posts)
    w = jidf_weights(df, n)
    p_loc = min(page, dp)
    ids, scores, tie = [], [], np.zeros(Q.shape[0], bool)
    for (lo, hi), p in zip(shards, posts):
        c = jnp.asarray(codes[lo:hi])
        if engine == "fused":
            s1 = jmatch_scores(c, qc, w)
        elif engine == "fused_int8":
            q8, sc, zp = jquantize_rows(jnp.asarray(v[lo:hi]))
            s1 = (q @ q8.astype(jnp.float32).T) * sc[None, :] \
                + jnp.sum(q, -1, keepdims=True) * zp[None, :]
        else:
            s1 = jsearch.phase1_engine_scores(
                c, JPostings(p.post_docs, p.post_codes, hi - lo), qc, w,
                engine, None, enc.max_abs_bucket)
        s1 = np.asarray(s1)
        order = np.argsort(-s1, axis=1, kind="stable")
        if p_loc < hi - lo:        # a tie across the page's edge
            edge = np.take_along_axis(s1, order[:, p_loc - 1:p_loc + 1], 1)
            tie |= np.abs(edge[:, 0] - edge[:, 1]) <= 1e-4 * np.abs(
                edge[:, 0]) + 1e-6
        cand = order[:, :p_loc]
        ids.append(cand + lo)
        scores.append(np.einsum("qpn,qn->qp", v[cand + lo], np.asarray(q)))
    ids, scores = np.concatenate(ids, 1), np.concatenate(scores, 1)
    top = np.argsort(-scores, axis=1, kind="stable")
    srt = np.take_along_axis(scores, top, 1)
    tie |= (np.abs(np.diff(srt[:, :k + 1], axis=1)) <= 1e-5).any(1)
    return (np.take_along_axis(ids, top[:, :k], 1), srt[:, :k], tie)


@pytest.mark.parametrize("engine", ENGINES)
def test_small_page_matches_per_shard_protocol(engine):
    """page < docs per shard: each shard keeps its own page.  The port at
    4 and 4 x 2 answers the reference's per-shard protocol's ids, scores
    within 1e-5, on every query no near-tie decides (most of them: noisy
    corpus rows under 0.1-wide buckets, so phase 1 ranks by real
    matches)."""
    n_docs, k = 123, 5
    V, _ = _data(n_docs, seed=4)
    rng = np.random.default_rng(9)
    Q = (V[rng.choice(n_docs, 24, replace=False)]
         + 0.02 * rng.normal(size=(24, N_FEAT))).astype(np.float32)
    for page in (6, 13):
        want_i, want_s, tie = _oracle(V, Q, engine, 4, page, k, 1)
        assert (~tie).sum() >= 12, (page, int((~tie).sum()))
        for S, R in LAYOUTS:
            sidx = ShardedVectorIndex.build_sharded(
                V, RoundingEncoder(1), mesh=_mesh(S, R))
            for merge in ("gather", "stream"):
                ids, s = sidx.search(Q, k=k, page=page, engine=engine,
                                     merge=merge)
                ok = ~tie
                assert np.array_equal(ids.numpy()[ok], want_i[ok]), \
                    (page, S, R, merge)
                np.testing.assert_allclose(s.numpy()[ok], want_s[ok],
                                           atol=TOL, rtol=0)


def test_transports_agree_when_k_exceeds_the_pages():
    """Fewer page slots than k, and ties across shards (duplicated rows in
    two shards): gather and stream give the same bits, lower shard first,
    and unfillable slots report (-1, -inf)."""
    V, Q = _data(40)
    V[30:40] = V[0:10]                     # shard 3 duplicates shard 0
    sidx = ShardedVectorIndex.build_sharded(V, mesh=_mesh(4, 2))
    sidx = sidx.delete(np.arange(3, 10))
    for engine in ENGINES:
        for k, page in ((10, 10), (25, 3), (40, 40)):
            a = sidx.search(Q, k=k, page=page, engine=engine)
            b = sidx.search(Q, k=k, page=page, engine=engine,
                            merge="stream")
            _same(a, b, (engine, k, page))
            assert a[0].shape == (len(Q), min(k, page))
            assert bool((torch.isneginf(a[1]) == (a[0] < 0)).all())
        ids, _ = sidx.search(V[:3], k=2, page=40, engine=engine)
        assert ids[:, 0].tolist() == [0, 1, 2], engine   # not 30, 31, 32


# ---------------------------------------------------------------- replicas
@pytest.mark.parametrize("engine", ["codes", "fused", "fused_int8"])
def test_replica_round_robin_every_batch_size(engine):
    """Batch sizes 1..8 (even, odd, fewer than R) on 4 x 2 and 2 x 4 equal
    the one-group index bit for bit, both transports, at page >= n_docs and
    at a small page: the zero pad rows never reach a caller."""
    V, _ = _data(123)
    Q = _data(123, seed=1, n_queries=8)[1]
    base = ShardedVectorIndex.build_sharded(V, mesh=_mesh(4))
    rep = {(4, 2): ShardedVectorIndex.build_sharded(V, mesh=_mesh(4, 2))}
    base2 = ShardedVectorIndex.build_sharded(V, mesh=_mesh(2))
    rep[(2, 4)] = ShardedVectorIndex.build_sharded(V, mesh=_mesh(2, 4))
    for (S, R), idx in rep.items():
        ref1 = base if S == 4 else base2
        for nq in range(1, 9):
            for page in (300, 16):
                for merge in ("gather", "stream"):
                    got = idx.search(Q[:nq], k=10, page=page, engine=engine,
                                     merge=merge)
                    assert got[0].shape == (nq, 10)
                    _same(got, ref1.search(Q[:nq], k=10, page=page,
                                           engine=engine, merge=merge),
                          (S, R, nq, page, merge))


def test_live_groups_and_replica_group():
    """Each single live group, any subset, and each replica_group answer as
    the whole; bad groups raise the reference's ValueErrors."""
    V, Q = _data(123)
    idx = ShardedVectorIndex.build_sharded(V, mesh=_mesh(4, 3))
    for engine in ENGINES:
        want = idx.search(Q, k=10, page=20, engine=engine, merge="stream")
        for groups in ((0,), (1,), (2,), (0, 2), (2, 1, 2)):
            _same(idx.search(Q, k=10, page=20, engine=engine,
                             merge="stream", live_groups=groups), want,
                  (engine, groups))
        for g in range(3):
            _same(idx.replica_group(g).search(Q, k=10, page=20,
                                              engine=engine,
                                              merge="stream"), want,
                  (engine, g))
    for bad in ((), (3,), (-1,), (0, 5)):
        with pytest.raises(ValueError, match="live_groups"):
            idx.search(Q, live_groups=bad)
    for bad in (-1, 3):
        with pytest.raises(ValueError, match="replica group"):
            idx.replica_group(bad)
    one = ShardedVectorIndex.build_sharded(V, mesh=_mesh(4))
    assert one.replica_group(0) is one


def test_profile_names_the_groups_that_served():
    from repro_torch.obs.profile import ProfileNode

    V, Q = _data(123)
    idx = ShardedVectorIndex.build_sharded(V, mesh=_mesh(4, 3))
    want = idx.search(Q, k=10, page=20)
    for groups, served in ((None, {"group0": 3, "group1": 3, "group2": 1}),
                           ((1, 2), {"group1": 4, "group2": 3})):
        root = ProfileNode("search")
        _same(idx.search(Q, k=10, page=20, live_groups=groups,
                         profile=root), want, groups)
        enc, p1 = root.children[0], root.children[1]
        assert enc.attrs["groups"] == len(served)
        got = {c.name: c.attrs["n_queries"] for c in p1.children
               if c.name.startswith("group")}
        assert got == served
        base = [c for c in p1.children if c.name == "base"][0]
        assert base.attrs["candidates"] == p1.attrs["candidates"] \
            == len(Q) * 4 * 20


# --------------------------------------------------------------- lifecycle
@pytest.mark.parametrize("engine", ENGINES)
def test_lifecycle_at_four_shards(engine):
    """The same history (ragged seals, deletes in the base, sealed and
    active rows across shards, a merge, a compact) on a segmented index at
    4 x 2, a flat one at 4 and a segmented one at 1 shard: at page >= n_ids
    all three bit-equal at every stage (the reference's pin; at a
    smaller page a row's shard, and so the shard pages, differ between
    segmented and flat, as in the reference: the active buffer routes on
    its own counter); at any page the 4 x 2 index equals its own group 0
    and transports agree; token_df equal throughout."""
    V, Q = _data(123)
    seg = ShardedVectorIndex.build_sharded(V, seal_threshold=4,
                                           mesh=_mesh(4, 2))
    flat = ShardedVectorIndex.build_sharded(V, seal_threshold=None,
                                            mesh=_mesh(4))
    one = ShardedVectorIndex.build_sharded(V, seal_threshold=4, device="cpu")
    hist = zip(_lifecycle(seg), _lifecycle(flat), _lifecycle(one))
    for (stage, a), (_, b), (_, c) in hist:
        assert a.n_ids == b.n_ids == c.n_ids
        assert a.n_tombstones == c.n_tombstones, stage
        p = 2 * a.n_ids
        got = a.search(Q, k=13, page=p, engine=engine)
        _same(got, b.search(Q, k=13, page=p, engine=engine), (stage, "flat"))
        _same(got, c.search(Q, k=13, page=p, engine=engine),
              (stage, "one shard"))
        got = a.search(Q, k=5, page=7, engine=engine)
        _same(got, a.replica_group(0).search(Q, k=5, page=7, engine=engine),
              (stage, "group 0"))
        _same(got, a.search(Q, k=5, page=7, engine=engine, merge="stream"),
              (stage, "stream"))
        assert torch.equal(a.token_df(Q), c.token_df(Q)), stage
        assert torch.equal(b.token_df(Q), c.token_df(Q)), stage
    assert a.n_segments == 2 and a.n_tombstones == 6     # 2 merged away
    a, b, c = a.compact(), b.compact(), c.compact()
    assert a.n_replicas == 2 and a.n_shards == 4 and a.n_segments == 0
    p = 2 * a.n_ids
    want = c.search(Q, k=13, page=p, engine=engine)
    _same(a.search(Q, k=13, page=p, engine=engine), want, "compacted")
    _same(b.search(Q, k=13, page=p, engine=engine), want, "flat compacted")
    # compacted, the layouts agree again at any page
    _same(a.search(Q, k=5, page=9, engine=engine),
          b.search(Q, k=5, page=9, engine=engine), "compacted, page 9")


def test_lifecycle_counters_and_per_shard_tombstones():
    V, _ = _data(123)
    idx = ShardedVectorIndex.build_sharded(V, seal_threshold=4,
                                           mesh=_mesh(4))
    idx = idx.add_documents(_rows(0, 5))       # seals: width 2 over 4
    assert idx.n_segments == 1 and idx.segments[0].width == 2
    assert idx.segments[0].gids.tolist() == [[123, 127], [124, -1],
                                             [125, -1], [126, -1]]
    # base rows 0 and 32 (shards 0, 1), sealed 124 (shard 1)
    idx = idx.delete([0, 32, 124, 124])
    assert idx.shard_tombstones == (1, 2, 0, 0)
    assert list(idx.shard_populations) == [33, 32, 32, 31]
    assert idx.tombstone_ratio == pytest.approx(2 / 32)


def test_lifecycle_token_df_max_df_and_leaves_match_reference(ref):
    """The reference's restore of the port's 4-shard commits (after the
    build, the deletes and the tail) rebuilds, with its own posting
    program, the port's leaves; its token_df and max_df equal the
    port's."""
    for name in ("built", "deleted", "tail"):
        port, key = ref.stages[name], f"restore/{name}"
        _assert_leaves(port, ref, key, name, vec_atol=0)
        for n in ACTIVE:
            assert np.array_equal(getattr(port, n).numpy(),
                                  ref.out[f"{key}/{n}"]), (name, n)
        assert int(ref.out[f"{key}/n_segments"]) == port.n_segments
        for i, seg in enumerate(port.segments):
            for n in SEG_LEAVES:
                assert np.array_equal(getattr(seg, n).numpy(),
                                      ref.out[f"{key}/seg{i}/{n}"]), \
                    (name, i, n)
        assert tuple(ref.out[f"{key}/shard_tombstones"]) == tuple(
            port.shard_tombstones or (0,) * 4)


# ------------------------------------------------------------------ engine
def test_batched_engine_serves_four_by_two():
    """BatchedSearchEngine over 4 x 2 with the stream transport, hot
    ingest (donated) and delete: every batch equals the index's own
    search; stats report the layout as the reference's index_stats."""
    V, Q = _data(123, n_queries=11)
    idx = ShardedVectorIndex.build_sharded(V, seal_threshold=8,
                                           mesh=_mesh(4, 2))
    eng = BatchedSearchEngine(idx, batch_size=4, max_wait_s=0.001, k=10,
                              page=40, engine="fused", merge="stream",
                              trim=TrimFilter(0.05), donate_ingest=True)
    try:
        for step in range(3):
            want = eng.index.search(Q, k=10, page=40, engine="fused",
                                    merge="stream", trim=TrimFilter(0.05))
            got = [f.result(timeout=60) for f in
                   [eng.submit(q) for q in Q]]
            assert np.array_equal(np.stack([g[0] for g in got]),
                                  want[0].numpy()), step
            assert np.array_equal(np.stack([g[1] for g in got]),
                                  want[1].numpy()), step
            eng.add_documents(_rows(step, 7))
            eng.delete([step, 123 + step])
        stats = eng.stats()["index"]
    finally:
        eng.close()
    assert (stats["n_shards"], stats["n_replicas"]) == (4, 2)
    assert stats["n_ids"] == 123 + 21 and sum(stats["shard_tombstones"]) == 6


def test_index_stats_reports_replicas_as_the_reference():
    """The small repair: index_stats of the port's one-shard index carries
    n_replicas, key for key with the reference's at one shard."""
    V, _ = _data(40)
    one = ShardedVectorIndex.build_sharded(V, device="cpu")
    jone = JSharded.build_sharded(jnp.asarray(V), jmesh(1))
    got, want = index_stats(one), jindex_stats(jone)
    assert got == want
    assert got["n_replicas"] == 1 and got["n_shards"] == 1
    wide = index_stats(ShardedVectorIndex.build_sharded(V, mesh=_mesh(4, 2)))
    assert (wide["n_shards"], wide["n_replicas"]) == (4, 2)


# ------------------------------------------------------------------- store
def test_reference_four_shard_commit_restores_onto_four_by_two(ref):
    """The reference's own 4-shard commit of the base restores in the port
    onto 4 x 2 as the port's build: leaves equal, answers bit-equal."""
    for n_docs in (123, 120):
        V = ref.inputs[f"V{n_docs}"]
        mesh = _mesh(4, 2)
        rec = restore(latest_commit(str(ref.ref_dirs / f"ref{n_docs}")),
                      mesh=mesh)
        want = ShardedVectorIndex.build_sharded(V, mesh=mesh)
        assert rec.mesh == mesh and rec.n_replicas == 2
        for n in LEAVES + ACTIVE:
            a, b = getattr(rec, n), getattr(want, n)
            if n == "vectors":
                torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
            else:
                assert torch.equal(a, b), (n_docs, n)


def test_commits_move_between_layouts(tmp_path):
    """A 4-shard commit written through the reference's writer restores
    verbatim at 4 x 2; commits at 1 and 4 shards restore onto each other's
    layout (rows re-placed as ingest and merge place them) with answers
    bit-equal at page >= n_ids; a one-shard commit of a fresh index onto
    4 shards equals from_index; Store.recover(mesh=) replays onto the
    mesh."""
    V, Q = _data(123)
    four = dict(_lifecycle(ShardedVectorIndex.build_sharded(
        V, seal_threshold=4, mesh=_mesh(4))))["tail"]
    one = dict(_lifecycle(ShardedVectorIndex.build_sharded(
        V, seal_threshold=4, device="cpu")))["tail"]
    jsnap.write_commit(str(tmp_path / "jax4"), _jax_writer(four), seq=3)
    rec = restore(latest_commit(str(tmp_path / "jax4")), mesh=_mesh(4, 2))
    for n in LEAVES + ACTIVE:
        assert torch.equal(getattr(rec, n), getattr(four, n)), n
    for a, b in zip(rec.segments, four.segments):
        for n in SEG_LEAVES:
            assert torch.equal(getattr(a, n), getattr(b, n)), n
    assert rec.shard_tombstones == four.shard_tombstones
    write_commit(str(tmp_path / "one"), one, seq=3)
    write_commit(str(tmp_path / "four"), four, seq=3)
    cases = (("one", _mesh(4, 2), one), ("four", None, four),
             ("four", _mesh(2), four))
    for src, mesh, live in cases:
        kw = {"device": "cpu"} if mesh is None else {"mesh": mesh}
        got = restore(latest_commit(str(tmp_path / src)), **kw)
        assert got.n_shards == (1 if mesh is None else mesh.n_shards)
        assert (got.n_ids, got.n_segments, got.n_tombstones) == \
            (live.n_ids, live.n_segments, live.n_tombstones), src
        for engine in ENGINES:
            p = 2 * live.n_ids
            _same(got.search(Q, k=9, page=p, engine=engine),
                  one.search(Q, k=9, page=p, engine=engine),
                  (src, mesh, engine))
        # and the restored layout keeps its lifecycle
        _same(got.add_documents(_rows(5, 6)).delete([1]).search(
            Q, k=9, page=400), one.add_documents(_rows(5, 6)).delete(
            [1]).search(Q, k=9, page=400), (src, mesh, "after"))
    fresh = VectorIndex.build(V, device="cpu")
    write_commit(str(tmp_path / "fresh"), fresh.shard(), seq=0)
    got = restore(latest_commit(str(tmp_path / "fresh")), mesh=_mesh(4))
    want = fresh.shard(_mesh(4))
    for n in LEAVES + ACTIVE:
        assert torch.equal(getattr(got, n), getattr(want, n)), n
    store = Store(str(tmp_path / "durable"))
    live = store.open_index(ShardedVectorIndex.build_sharded(
        V, seal_threshold=4, mesh=_mesh(4)))
    live = live.add_documents(_rows(1, 9)).delete([5, 125])
    store.close()
    store = Store(str(tmp_path / "durable"))
    rec, seq = store.recover(mesh=_mesh(4, 2))
    assert seq == live.translog_seq == 2 and rec.n_replicas == 2
    for n in LEAVES + ACTIVE:
        assert torch.equal(getattr(rec.inner, n), getattr(live.inner, n)), n
    _same(rec.search(Q, k=9, page=40), live.search(Q, k=9, page=40),
          "recovered")
    rec2, _ = recover(str(tmp_path / "durable"), mesh=_mesh(4))
    _same(rec2.search(Q, k=9, page=40), live.search(Q, k=9, page=40),
          "recover()")
    store.close()
    with pytest.raises(ValueError, match="not both"):
        restore(latest_commit(str(tmp_path / "one")), "cpu", mesh=_mesh(4))


def test_sharded_from_numpy_carries_reference_leaves(ref):
    """interop.sharded_from_numpy at 4 shards over the reference's build
    leaves, onto 4 x 2: the port's own 4 x 2 index's leaves and answers."""
    key = "build/123/None/4x1"
    got = interop.sharded_from_numpy(
        *(ref.out[f"{key}/{n}"] for n in LEAVES), RoundingEncoder(2), 123,
        mesh=_mesh(4, 2))
    want = ShardedVectorIndex.build_sharded(ref.inputs["V123"],
                                            mesh=_mesh(4, 2))
    assert got.n_replicas == 2
    Q = ref.inputs["Q"]
    for engine in ENGINES:
        a = got.search(Q, k=10, page=300, engine=engine)
        b = want.search(Q, k=10, page=300, engine=engine)
        assert torch.equal(a[0], b[0]), engine
        torch.testing.assert_close(a[1], b[1], atol=TOL, rtol=0)
