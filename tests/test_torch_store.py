"""repro_torch.store: translog, commit points and crash recovery at one
shard, held two ways.

1. To the JAX package's files (``repro.store``): the same ops give
   byte-identical translog generations and each package reads the
   other's; the port's RSEG blobs are ``_pack_blob``'s bytes; a JAX commit
   restores in the port leaf-equal (posting tables included) and answers
   as the same index carried by ``interop.sharded_from_numpy``; the port's
   commit of that carried index is JAX's directory byte for byte;
   hand-written JAX commits with segments, tombstones and an active
   buffer at writer shards 1 and 4 restore in the port as JAX's own
   ``restore`` at one shard does; a port commit restores in JAX
   leaf-equal; ``store_stats`` equals JAX's.  (JAX's sharded index cannot
   ingest on the CPU here, so JAX commits with segments are written from
   a namespace of numpy leaves, which is all ``write_commit`` reads.)
2. To the port's own invariant, the one ``tests/test_store.py`` pins for
   JAX: an index recovered from disk alone is bit-identical to the
   never-crashed one, leaves and answers of all six engines, at every
   kill point of ingest, delete, merge and compact, under ``request`` and
   ``async`` durability; plus the translog's torn-tail, corruption, gap
   and trim rules, commit fallback, retention and GC, O(changed) bytes,
   the write-through order through the engine (which never donates a
   durable index) and the merge kill points.

Everything runs on the CPU at the JAX tests' sizes (30-64 docs x 10-16
features).
"""

import json
import os
import shutil
import tempfile
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import encoding as jenc
from repro.dist.shard_index import ShardedVectorIndex as JSharded
from repro.launch.mesh import make_shard_mesh
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.store import Store as JStore
from repro.store import snapshot as jsnap
from repro.store import translog as jtl
from repro_torch import interop
from repro_torch.core import encoding as tenc
from repro_torch.dist import ShardedVectorIndex
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import BatchedSearchEngine
from repro_torch.store import (OP_ADD, NoCommitError, Store, Translog,
                               TranslogCorruptedError, latest_commit,
                               read_ops, recover, restore, write_commit)
from repro_torch.store import snapshot as tsnap
from repro_torch.store import translog as ttl

ENGINES = ("postings", "codes", "onehot", "codes_pallas", "fused",
           "fused_int8")
LEAVES = ("vectors", "codes", "post_docs", "post_codes", "offsets", "live",
          "seg_vectors", "seg_codes", "seg_gids", "seg_live")
SEG_LEAVES = ("vectors", "codes", "gids", "live", "post_docs", "post_codes")
COUNTERS = ("n_docs", "n_appended", "seg_base", "active_tombstones",
            "seal_threshold", "index_best")


def _build(n_docs=30, dims=10, seed=0, seal_threshold=256):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n_docs, dims)).astype(np.float32)
    idx = ShardedVectorIndex.build_sharded(V, seal_threshold=seal_threshold,
                                           device="cpu")
    return idx, V, rng


def _rows(rng, m, dims=10):
    return rng.normal(size=(m, dims)).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_leaves_equal(a, b, ctx):
    """Every leaf, every segment's leaves and every counter equal; ``a``
    and ``b`` may each be a port or a JAX index."""
    for name in LEAVES:
        x, y = _np(getattr(a, name)), _np(getattr(b, name))
        assert x.dtype == y.dtype and np.array_equal(x, y), (ctx, name)
    for name in COUNTERS:
        assert getattr(a, name) == getattr(b, name), (ctx, name)
    assert tuple(a.shard_tombstones or ()) == \
        tuple(b.shard_tombstones or ()), ctx
    assert len(a.segments) == len(b.segments), ctx
    for si, (sa, sb) in enumerate(zip(a.segments, b.segments)):
        assert (sa.n_rows, sa.tombstones) == (sb.n_rows, sb.tombstones), \
            (ctx, si)
        for name in SEG_LEAVES:
            x, y = _np(getattr(sa, name)), _np(getattr(sb, name))
            assert x.dtype == y.dtype and np.array_equal(x, y), \
                (ctx, si, name)


def _assert_bit_identical(live, rec, queries, ctx, *, leaves=True):
    if leaves:
        _assert_leaves_equal(live, rec, ctx)
        assert rec.encoder == live.encoder, ctx
    assert live.n_ids == rec.n_ids and live.n_docs == rec.n_docs, ctx
    for engine in ENGINES:
        for page in (7, 2 * live.n_ids):
            i1, s1 = live.search(queries, k=8, page=page, engine=engine)
            i2, s2 = rec.search(queries, k=8, page=page, engine=engine)
            assert torch.equal(i1, i2), (ctx, engine, page)
            assert torch.equal(s1, s2), (ctx, engine, page)


def _dir_bytes(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def _segmented(seed=0, seal_threshold=4):
    """A port index with 3 sealed segments and 3 rows in the active
    buffer, with tombstones in the base, two segments and the buffer."""
    idx, V, rng = _build(seed=seed, seal_threshold=seal_threshold)
    for m in (5, 5, 5, 3):
        idx = idx.add_documents(_rows(rng, m))
    idx = idx.delete([2, 31, 43, 46])
    assert idx.n_segments == 3 and idx.n_active == 3
    assert idx.active_tombstones == 1 and idx.n_tombstones == 4
    return idx, V, rng


# ------------------------------------------------ files shared with JAX
def _translog_history(mod, path):
    """One op history through ``mod``'s Translog: adds, deletes, a roll,
    a trim, a reopen."""
    rng = np.random.default_rng(3)
    log = mod.Translog(path)
    log.add(_rows(rng, 4, 6))
    log.delete([3, 7])
    log.add(_rows(rng, 1, 6)[0])            # 1-D rows log as given
    log.roll()
    log.delete(np.arange(5))
    log.roll()
    log.trim(2)
    log.close()
    log = mod.Translog(path, durability="async")
    log.add(_rows(rng, 2, 6))
    log.close()


def test_translog_files_match_jax_and_read_across(tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _translog_history(jtl, jdir)
    _translog_history(ttl, tdir)
    want, got = _dir_bytes(jdir), _dir_bytes(tdir)
    assert list(got) == list(want) and len(want) >= 3
    for name in want:
        assert got[name] == want[name], name
    for a, b in ((jdir, tdir), (tdir, jdir)):
        ja = list(jtl.read_ops(a, truncate_torn=False))
        tb = list(read_ops(b, truncate_torn=False))
        assert [(s, op) for s, op, _ in ja] == [(s, op) for s, op, _ in tb]
        for (_, _, x), (_, _, y) in zip(ja, tb):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert [s for s, _, _ in read_ops(jdir, after_seq=2)] == [3, 4, 5]


_BLOBS = {
    "f32": {"vectors": np.random.default_rng(0).normal(
        size=(7, 5)).astype(np.float32)},
    "int8": {"codes": np.arange(-60, 60, dtype=np.int8).reshape(8, 15)},
    "int16": {"codes": np.arange(-900, 900, 7, dtype=np.int16)
              .reshape(-1, 1)},
    "int32": {"gids": np.array([[4, 9, -1], [5, 10, -1]], np.int32)},
    "bool": {"live": np.array([[True, False, True, True]])},
    "empty": {"vectors": np.zeros((1, 0, 12), np.float32),
              "codes": np.zeros((1, 0, 12), np.int8),
              "gids": np.zeros((1, 0), np.int32),
              "live": np.zeros((1, 0), bool)},
    "mixed": {"vectors": np.ones((3, 4), np.float32),
              "codes": np.full((3, 4), 127, np.int8),
              "gids": np.array([[30, 31, -1]], np.int32),
              "live": np.array([[True, False, False]])},
}


@pytest.mark.parametrize("case", sorted(_BLOBS))
def test_blob_bytes_match_jax_pack_blob(tmp_path, case):
    """The streamed blob is ``_pack_blob``'s bytes, under the same name
    and entry; both packages read each other's blob back."""
    arrays = _BLOBS[case]
    want = jsnap._pack_blob(arrays)
    stats = {"bytes_written": 0, "bytes_total": 0, "blobs_written": 0}
    entry = tsnap._write_blob(str(tmp_path), arrays, stats)
    jstats = {"bytes_written": 0, "bytes_total": 0, "blobs_written": 0}
    jdir = tmp_path / "jax"
    jdir.mkdir()
    assert jsnap._write_blob(str(jdir), arrays, jstats) == entry
    assert stats == jstats == {"bytes_written": len(want),
                               "bytes_total": len(want), "blobs_written": 1}
    with open(tmp_path / entry["file"], "rb") as f:
        assert f.read() == want
    back = tsnap._read_blob(str(tmp_path / entry["file"]))
    jback = jsnap._unpack_blob(str(jdir / entry["file"]))
    assert list(back) == list(jback) == list(arrays)
    for name, a in arrays.items():
        assert back[name].numpy().dtype == a.dtype
        assert np.array_equal(back[name].numpy(), a)
        assert back[name].numpy().flags.writeable
        assert np.array_equal(jback[name], a)
    # again: the same content is only referenced
    tsnap._write_blob(str(tmp_path), arrays, stats)
    assert stats["bytes_written"] == len(want)
    assert stats["bytes_total"] == 2 * len(want)


def _jax_base(seed=0, n_docs=30, dims=10):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n_docs, dims)).astype(np.float32)
    jidx = JSharded.build_sharded(jnp.asarray(V), make_shard_mesh(1),
                                  encoder=jenc.RoundingEncoder(2))
    carried = interop.sharded_from_numpy(
        *(np.asarray(getattr(jidx, n)) for n in LEAVES[:6]),
        tenc.RoundingEncoder(2), jidx.n_docs, jidx.index_best,
        seal_threshold=jidx.seal_threshold, device="cpu")
    return jidx, carried, rng


def test_jax_commit_restores_in_port(tmp_path):
    """A JAX commit restored in the port: leaves equal to JAX's index and
    to JAX's own restore, and every engine answers as the index carried
    by ``interop`` does, bit for bit."""
    jidx, carried, rng = _jax_base()
    Q = _rows(rng, 4)
    jsnap.write_commit(str(tmp_path), jidx, seq=5)
    commit = latest_commit(str(tmp_path))
    assert commit.seq == 5 and commit.generation == 1
    rec = restore(commit, device="cpu")
    _assert_leaves_equal(rec, jidx, "port restore vs JAX index")
    _assert_leaves_equal(rec, jsnap.restore(jsnap.latest_commit(
        str(tmp_path)), make_shard_mesh(1)), "port vs JAX restore")
    _assert_bit_identical(carried, rec, Q, "carried vs restored")


def test_port_commit_is_jax_commit_byte_for_byte(tmp_path):
    jidx, carried, _ = _jax_base(seed=1)
    jsnap.write_commit(str(tmp_path / "jax"), jidx, seq=3)
    stats = {}
    write_commit(str(tmp_path / "port"), carried, 3, stats)
    want, got = _dir_bytes(tmp_path / "jax"), _dir_bytes(tmp_path / "port")
    assert list(got) == list(want) and len(want) == 3   # manifest + 2 blobs
    for name in want:
        assert got[name] == want[name], name
    assert stats["bytes_written"] == stats["bytes_total"] > 0


def _writer_layout(idx, ns, encoder):
    """What ``repro.store.snapshot.write_commit`` reads of an ``ns``-shard
    JAX index holding ``idx``'s content: the base padded round the shards
    in blocks, active rows at (j % ns, j // ns) by append offset j, sealed
    rows round-robin by gid rank, and the tombstones by shard."""
    n, nf, C = idx.n_docs, idx.n_features, idx.codes.shape[-1]
    dp = -(-n // ns)
    cdt = idx.codes.numpy().dtype
    sent = int(np.iinfo(cdt).max)

    def pad(a, fill, shape):
        out = np.full(shape, fill, a.dtype)
        out.reshape(ns * dp, -1)[:n] = a.reshape(n, -1)
        return out

    stones = np.zeros(ns, np.int64)
    base_dead = np.nonzero(~idx.live[0].numpy())[0]
    np.add.at(stones, base_dead // dp, 1)

    def rr(vec, cod, gid, liv, width):
        used = gid >= 0
        order = np.argsort(gid[used], kind="stable")
        r = np.arange(order.size)
        s, g = r % ns, r // ns
        mv = np.zeros((ns, width, nf), np.float32)
        mc = np.full((ns, width, C), sent, cdt)
        mg = np.full((ns, width), -1, np.int32)
        ml = np.zeros((ns, width), bool)
        mv[s, g] = vec[used][order]
        mc[s, g] = cod[used][order]
        mg[s, g] = gid[used][order]
        ml[s, g] = liv[used][order]
        np.add.at(stones, s[~ml[s, g]], 1)
        return mv, mc, mg, ml

    segs = []
    for seg in idx.segments:
        mv, mc, mg, ml = rr(seg.vectors[0].numpy(), seg.codes[0].numpy(),
                            seg.gids[0].numpy(), seg.live[0].numpy(),
                            -(-seg.n_rows // ns))
        segs.append(types.SimpleNamespace(
            vectors=mv, codes=mc, gids=mg, live=ml, n_rows=seg.n_rows,
            tombstones=seg.tombstones))
    # one shard keeps the index's own capacity; more take one spare slot
    G = idx.seg_capacity if ns == 1 else -(-idx.n_active // ns) + 1
    sv, sc, sg, sl = rr(idx.seg_vectors[0].numpy(), idx.seg_codes[0].numpy(),
                        idx.seg_gids[0].numpy(), idx.seg_live[0].numpy(), G)
    assert int(stones.sum()) == idx.n_tombstones
    return types.SimpleNamespace(
        n_shards=ns, docs_per_shard=dp, n_features=nf, n_docs=n,
        n_active=idx.n_active, n_appended=idx.n_appended,
        seg_base=idx.seg_base, active_tombstones=idx.active_tombstones,
        seal_threshold=idx.seal_threshold, seg_capacity=G,
        shard_tombstones=tuple(int(t) for t in stones),
        index_best=idx.index_best, encoder=encoder,
        vectors=pad(idx.vectors[0].numpy(), 0.0, (ns, dp, nf)),
        codes=pad(idx.codes[0].numpy(), sent, (ns, dp, C)),
        live=pad(idx.live[0].numpy(), False, (ns, dp)),
        seg_vectors=sv, seg_codes=sc, seg_gids=sg, seg_live=sl,
        segments=segs)


@pytest.mark.parametrize("shards,precision", [(1, 2), (4, 2), (4, 3)])
def test_handwritten_jax_commit_restores_in_port(tmp_path, shards,
                                                 precision):
    """A JAX commit with sealed segments, tombstones and an active buffer,
    written by ``repro.store.snapshot.write_commit`` at 1 or 4 writer
    shards (int8 and int16 codes): the port's restore equals JAX's
    ``restore`` at one shard, posting tables and counters included."""
    idx, _, rng = _segmented(seed=precision)
    if precision != 2:
        idx = ShardedVectorIndex.build_sharded(
            _rows(rng, 30), tenc.RoundingEncoder(precision),
            seal_threshold=4, device="cpu")
        for m in (5, 4, 3):
            idx = idx.add_documents(_rows(rng, m))
        idx = idx.delete([0, 33, 41])
        assert idx.codes.dtype == torch.int16
    ns = _writer_layout(idx, shards, jenc.RoundingEncoder(precision))
    jsnap.write_commit(str(tmp_path), ns, seq=9)
    with open(tmp_path / "commit-00000001.json") as f:
        assert json.load(f)["writer_shards"] == shards
    rec = restore(latest_commit(str(tmp_path)), device="cpu")
    jrec = jsnap.restore(jsnap.latest_commit(str(tmp_path)),
                         make_shard_mesh(1))
    _assert_leaves_equal(rec, jrec, ("JAX writer", shards))
    if shards == 1:
        _assert_leaves_equal(rec, idx, "one-shard writer: the source")
    Q = _rows(rng, 4)
    _assert_bit_identical(idx, rec, Q, ("answers", shards), leaves=False)


def test_port_commit_restores_in_jax(tmp_path):
    idx, _, _ = _segmented(seed=5)
    write_commit(str(tmp_path), idx, 4)
    jrec = jsnap.restore(jsnap.latest_commit(str(tmp_path)),
                         make_shard_mesh(1))
    _assert_leaves_equal(jrec, idx, "JAX restore of a port commit")
    assert jrec.encoder == jenc.RoundingEncoder(2)


def test_store_stats_match_jax(tmp_path):
    """Two stores with the same base-only history (baseline commit, two
    logged ops, a second commit): ``Store.stats()`` equal key for key and
    value for value, apart from the path and the durations."""
    jidx, carried, rng = _jax_base(seed=2)
    W = _rows(rng, 3)
    jst = JStore(str(tmp_path / "jax"), metrics=JRegistry())
    tst = Store(str(tmp_path / "port"), metrics=MetricsRegistry())
    for st_, idx in ((jst, jidx), (tst, carried)):
        opened = st_.open_index(idx)
        st_.translog.add(W)
        st_.translog.delete([4])
        st_.commit(opened, seq=2)
    a, b = jst.stats(), tst.stats()
    for s in (a, b):
        s.pop("path")
        for key in ("commit_duration_s", "recovery_duration_s"):
            s[key] = s[key]["count"]
    assert a == b
    assert b["commits"] == 2 and b["commit"] == {"generation": 2, "seq": 2}
    assert b["translog"]["seqno"] == 2 and b["commit_duration_s"] == 2
    jst.close()
    tst.close()


# ---------------------------------------------------------------- translog
def test_translog_append_replay_roundtrip(tmp_path):
    log = Translog(str(tmp_path))
    V = _rows(np.random.default_rng(0), 4, 6)
    assert log.seqno == 0
    assert log.add(V) == 1
    assert log.delete([3, 7]) == 2
    assert log.add(V[:2]) == 3
    log.close()
    ops = list(read_ops(str(tmp_path)))
    assert [s for s, _, _ in ops] == [1, 2, 3]
    assert np.array_equal(ops[0][2], V)
    assert np.array_equal(ops[1][2], np.asarray([3, 7], np.int64))
    assert [s for s, _, _ in read_ops(str(tmp_path), after_seq=2)] == [3]


def test_translog_truncates_torn_tail(tmp_path):
    log = Translog(str(tmp_path))
    V = np.ones((2, 4), np.float32)
    log.add(V)
    log.add(2 * V)
    path = os.path.join(str(tmp_path), f"translog-{log.generation:08d}.log")
    log.close()
    size = os.path.getsize(path)
    with open(path, "r+b") as f:        # crash mid-append: half a record
        f.truncate(size - 7)
    assert [s for s, _, _ in read_ops(str(tmp_path))] == [1]
    assert os.path.getsize(path) < size - 7
    log = Translog(str(tmp_path))
    assert log.seqno == 1 and log.add(V) == 2
    log.close()


def test_translog_corruption_mid_stream_raises(tmp_path):
    log = Translog(str(tmp_path))
    log.add(np.ones((2, 4), np.float32))
    gen1 = log.generation
    log.roll()
    log.add(np.ones((1, 4), np.float32))
    log.close()
    path = os.path.join(str(tmp_path), f"translog-{gen1:08d}.log")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - 3)
        f.write(b"\xff\xff\xff")
    with pytest.raises(TranslogCorruptedError, match="corrupt record"):
        list(read_ops(str(tmp_path)))


def test_translog_torn_header_artifact_never_bricks(tmp_path):
    log = Translog(str(tmp_path))
    V = np.ones((2, 4), np.float32)
    log.add(V)
    gen = log.generation
    log.close()
    with open(tmp_path / f"translog-{gen + 1:08d}.log", "wb") as f:
        f.write(b"RT")                              # header torn mid-write
    log = Translog(str(tmp_path))
    assert log.seqno == 1
    log.add(V)
    log.close()
    assert [s for s, _, _ in read_ops(str(tmp_path))] == [1, 2]
    log = Translog(str(tmp_path))
    assert log.seqno == 2
    log.close()


def test_translog_gap_past_commit_raises(tmp_path):
    log = Translog(str(tmp_path))
    for _ in range(3):
        log.add(np.ones((1, 4), np.float32))
        log.roll()
    log.trim(2)
    log.close()
    assert [s for s, _, _ in read_ops(str(tmp_path), after_seq=2)] == [3]
    with pytest.raises(TranslogCorruptedError, match="gap"):
        list(read_ops(str(tmp_path), after_seq=0))


def test_translog_seqno_survives_trim_and_reopen(tmp_path):
    log = Translog(str(tmp_path))
    for _ in range(4):
        log.add(np.ones((1, 3), np.float32))
    log.roll()
    log.trim(4)
    log.close()
    log = Translog(str(tmp_path))
    assert log.seqno == 4
    assert log.add(np.ones((1, 3), np.float32)) == 5
    log.close()


def test_translog_durability_validates(tmp_path):
    with pytest.raises(ValueError, match="durability"):
        Translog(str(tmp_path), durability="yolo")
    log = Translog(str(tmp_path), durability="async")
    log.add(np.ones((1, 3), np.float32))
    log.sync()
    log.close()
    assert len(list(read_ops(str(tmp_path)))) == 1


def test_recover_rejects_unknown_op(tmp_path):
    idx, _, _ = _build()
    store = Store(str(tmp_path), metrics=MetricsRegistry())
    store.open_index(idx)
    store.translog.append(7, np.zeros(2, np.int64))
    with pytest.raises(TranslogCorruptedError, match="unknown translog op 7"):
        recover(str(tmp_path), device="cpu")
    store.close()


# ------------------------------------------------------------ commit point
def test_commit_restore_leaf_identical(tmp_path):
    idx, _, rng = _build()
    Q = _rows(rng, 4)
    idx = idx.add_documents(_rows(rng, 5)).delete([2, 31])
    gen = write_commit(str(tmp_path), idx, seq=7)
    commit = latest_commit(str(tmp_path))
    assert commit.generation == gen and commit.seq == 7
    _assert_bit_identical(idx, restore(commit, device="cpu"), Q, "restore")


def test_commit_falls_back_past_damaged_newest(tmp_path):
    idx, _, rng = _build()
    write_commit(str(tmp_path), idx, seq=1)
    write_commit(str(tmp_path), idx.add_documents(_rows(rng, 3)), seq=2)
    with open(tmp_path / "commit-00000002.json") as f:
        active = json.load(f)["files"]["active"]["file"]
    with open(tmp_path / active, "r+b") as f:
        f.seek(10)
        f.write(b"\x00" * 8)
    commit = latest_commit(str(tmp_path))
    assert commit is not None and commit.seq == 1
    assert restore(commit, device="cpu").n_ids == 30


def test_commit_retention_prunes_old_generations(tmp_path):
    grown, _, rng = _build()
    for seq in range(1, 5):
        grown = grown.add_documents(_rows(rng, 2))
        write_commit(str(tmp_path), grown, seq=seq)
    names = sorted(os.listdir(tmp_path))
    manifests = [n for n in names if n.startswith("commit-")]
    assert manifests == ["commit-00000003.json", "commit-00000004.json"]
    referenced = set()
    for m in manifests:
        with open(tmp_path / m) as f:
            referenced |= tsnap._referenced_blobs(json.load(f))
    assert {n for n in names if n.endswith(".seg")} == referenced
    assert restore(latest_commit(str(tmp_path)), device="cpu").n_ids == 38


def test_commit_bytes_are_o_changed(tmp_path):
    idx, _, rng = _build()
    s0: dict = {}
    write_commit(str(tmp_path), idx, seq=1, stats=s0)
    assert s0["bytes_written"] == s0["bytes_total"]
    grown = idx.add_documents(_rows(rng, 2))
    s1: dict = {}
    write_commit(str(tmp_path), grown, seq=2, stats=s1)
    assert 0 < s1["bytes_written"] < s1["bytes_total"]
    assert s1["blobs_written"] == 1
    s2: dict = {}
    write_commit(str(tmp_path), grown, seq=2, stats=s2)
    assert s2["bytes_written"] == 0 and s2["blobs_written"] == 0


def test_blob_memo_reads_only_changed_parts(tmp_path, monkeypatch):
    """A writer's memo: a second commit of unchanged parts hashes none of
    them; a donated add writes the active buffer in place, and the next
    commit hashes and writes that part alone, into the manifest a writer
    with no memo writes."""
    digests = []
    real = tsnap._digest
    monkeypatch.setattr(tsnap, "_digest",
                        lambda *a: digests.append(1) or real(*a))
    idx, _, rng = _build(seal_threshold=None)
    idx = idx.add_documents(_rows(rng, 3))       # capacity 8
    memo, a = tsnap._BlobMemo(), str(tmp_path / "a")
    write_commit(a, idx, 1, memo=memo)
    assert len(digests) == 3                     # base x2, active
    stats: dict = {}
    write_commit(a, idx, 1, stats, memo)
    assert len(digests) == 3 and stats["bytes_written"] == 0
    grown = idx.add_documents(_rows(rng, 2), donate=True)
    assert grown.seg_vectors is idx.seg_vectors  # written in place
    write_commit(a, grown, 2, stats, memo)
    assert len(digests) == 4 and stats["blobs_written"] == 1
    write_commit(str(tmp_path / "b"), grown, 2)
    got = json.loads((tmp_path / "a" / "commit-00000003.json").read_bytes())
    want = json.loads((tmp_path / "b" / "commit-00000001.json").read_bytes())
    assert got["files"] == want["files"]
    _assert_leaves_equal(restore(latest_commit(a), device="cpu"), grown,
                         "in-place write")


def test_commit_refuses_active_gids_out_of_round_robin(tmp_path):
    """The writer's invariant: active-buffer gids in append order, or no
    snapshot (it would not restore bit-identically)."""
    import dataclasses

    idx, _, rng = _build()
    idx = idx.add_documents(_rows(rng, 3))
    gids = idx.seg_gids.clone()
    gids[0, [0, 1]] = gids[0, [1, 0]]
    bad = dataclasses.replace(idx, seg_gids=gids)
    with pytest.raises(ValueError, match="round-robin"):
        write_commit(str(tmp_path), bad, seq=1)
    assert not [n for n in os.listdir(tmp_path) if n.startswith("commit-")]

def test_gc_keeps_blobs_referenced_by_fallback_commit(tmp_path):
    idx, _, rng = _build(seal_threshold=4)
    for _ in range(2):
        idx = idx.add_documents(_rows(rng, 5))
    assert idx.n_segments == 2
    write_commit(str(tmp_path), idx, seq=1)
    with open(tmp_path / "commit-00000001.json") as f:
        gen1 = {e["file"] for e in json.load(f)["files"]["segments"]}
    assert gen1
    write_commit(str(tmp_path), idx.merge_segments(), seq=2)
    for blob in gen1:
        assert os.path.exists(tmp_path / blob), blob
    with open(tmp_path / "commit-00000002.json") as f:
        gen2 = {e["file"] for e in json.load(f)["files"]["segments"]}
    with open(tmp_path / sorted(gen2 - gen1)[0], "r+b") as f:
        f.seek(10)
        f.write(b"\x00" * 8)
    commit = latest_commit(str(tmp_path))
    assert commit is not None and commit.seq == 1
    assert restore(commit, device="cpu").n_ids == 40


def test_recover_without_commit_raises(tmp_path):
    with pytest.raises(NoCommitError):
        recover(str(tmp_path), device="cpu")


# ------------------------------------------------- crash-recovery property
@pytest.mark.parametrize("durability", ["request", "async"])
@settings(max_examples=5, deadline=None)
@given(n_docs=st.integers(8, 40), dims=st.integers(4, 12),
       n_ops=st.integers(1, 5), seed=st.integers(0, 2**20))
def test_crash_recovery_bit_parity_sweep(durability, n_docs, dims, n_ops,
                                         seed):
    """THE property: random ingest/delete/merge/compact/commit
    interleavings with a kill point at EVERY stage boundary -- the index
    recovered from disk alone is bit-identical to the live one, leaves
    and the answers of all six engines.  The seal threshold is tiny, so
    appends seal and replay must re-seal at identical boundaries.  Merge
    and compact pair with a commit."""
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n_docs, dims)).astype(np.float32)
    Q = rng.normal(size=(4, dims)).astype(np.float32)
    store_dir = tempfile.mkdtemp(prefix="repro_torch_store_")
    store = Store(store_dir, durability=durability,
                  metrics=MetricsRegistry())
    live = store.open_index(ShardedVectorIndex.build_sharded(
        V, seal_threshold=4, device="cpu"))
    try:
        for stage in range(n_ops + 1):
            if durability == "async":
                store.translog.sync()   # a kill is a process death, not a
                #                         power loss: the OS keeps the bytes
            rec, seq = recover(store_dir, device="cpu")
            assert seq == live.translog_seq, stage
            _assert_bit_identical(live.inner, rec, Q, (seed, stage))
            if stage == n_ops:
                break
            op = rng.choice(["add", "delete", "merge", "compact"])
            if op == "add":
                live = live.add_documents(rng.normal(
                    size=(int(rng.integers(1, 6)), dims)).astype(np.float32))
            elif op == "delete":
                live = live.delete(rng.choice(
                    live.n_ids, size=min(3, live.n_ids), replace=False))
            elif op == "merge" and live.n_segments:
                live = live.merge_segments(
                    0, int(rng.integers(1, live.n_segments + 1)))
                store.commit(live)
            elif op == "compact":
                live = live.compact()
                store.commit(live)
            if rng.random() < 0.3:
                store.commit(live)                  # mid-stream commit
    finally:
        store.close()
        shutil.rmtree(store_dir, ignore_errors=True)


# ----------------------------------------------------- engine wiring
def test_durable_index_logs_before_ack_and_is_never_donated(tmp_path):
    """Write-through order through the engine: the seqno moves with every
    ingest and delete, a tensor batch is logged as its float32 host rows,
    recovery replays exactly the acked history -- and an engine built with
    ``donate_ingest=True`` leaves every earlier state's buffers as they
    were (a durable index takes no ``donate``)."""
    idx, _, rng = _build()
    Q = _rows(rng, 3)
    store = Store(str(tmp_path), metrics=MetricsRegistry())
    eng = BatchedSearchEngine(store.open_index(idx), batch_size=2, trim=None,
                              engine="codes", donate_ingest=True,
                              metrics=MetricsRegistry())
    try:
        assert store.seqno == 0
        W = torch.from_numpy(_rows(rng, 4)).double()
        assert eng.add_documents(W) == 30 and store.seqno == 1
        before = eng.index.inner
        kept = {n: getattr(before, n).clone() for n in LEAVES[6:]}
        assert eng.add_documents(_rows(rng, 2)) == 34   # fits the buffer
        for n, t in kept.items():                       # not donated
            assert torch.equal(getattr(before, n), t), n
        eng.delete(torch.tensor([1, 30]))
        assert store.seqno == 3 and eng.index.translog_seq == 3
        _, op, payload = next(read_ops(str(tmp_path)))
        assert op == OP_ADD and payload.dtype == np.float32
        assert np.array_equal(payload, W.float().numpy())
        rec, seq = recover(str(tmp_path), device="cpu")
        assert seq == 3
        _assert_bit_identical(eng.index.inner, rec, Q, "engine write-through")
    finally:
        eng.close()
    store.close()


def test_failing_op_is_never_logged(tmp_path):
    idx, _, rng = _build()
    store = Store(str(tmp_path), metrics=MetricsRegistry())
    live = store.open_index(idx)
    with pytest.raises(ValueError, match="feature"):
        live.add_documents(np.ones((2, 99), np.float32))
    with pytest.raises(ValueError, match="ids must be"):
        live.delete([10_000])
    assert store.seqno == 0
    live = live.add_documents(_rows(rng, 2))
    assert store.seqno == 1
    rec, seq = recover(str(tmp_path), device="cpu")
    assert seq == 1 and rec.n_ids == 32
    store.close()


def test_open_index_refuses_dirty_store(tmp_path):
    idx, _, rng = _build()
    store = Store(str(tmp_path), metrics=MetricsRegistry())
    store.open_index(idx).add_documents(_rows(rng, 2))
    store.close()
    store = Store(str(tmp_path), metrics=MetricsRegistry())
    with pytest.raises(ValueError, match="already holds history"):
        store.open_index(idx)
    rec, seq = store.recover(device="cpu")
    assert seq == 1 and rec.translog_seq == 1 and rec.n_ids == 32
    assert store.stats()["recoveries"] == 1
    store.close()


def test_merge_kill_points_recover_bit_identical(tmp_path):
    """A crash before the merged index is swapped in, after the swap but
    before the commit, and after the commit: each recovers bit-identically
    -- the pre-merge layout until the commit lands (which answers exactly
    as the merged one), the merged layout after."""
    idx, _, rng = _build(n_docs=24, seal_threshold=4)
    Q = _rows(rng, 4)
    store = Store(str(tmp_path), metrics=MetricsRegistry())
    live = store.open_index(idx)
    for _ in range(3):
        live = live.add_documents(_rows(rng, 5))
    pre = live = live.delete([30, 31, 36])
    assert live.n_segments >= 2

    merged = pre.merge_segments(0, 2)                  # 1: before the swap
    rec, seq = recover(str(tmp_path), device="cpu")
    assert seq == pre.translog_seq
    _assert_bit_identical(pre.inner, rec, Q, "before swap")

    live = merged                                      # 2: swapped, no commit
    rec, seq = recover(str(tmp_path), device="cpu")
    assert seq == live.translog_seq
    _assert_bit_identical(pre.inner, rec, Q, "after swap")
    _assert_bit_identical(live.inner, rec, Q, "merged answers", leaves=False)

    store.commit(live)                                 # 3: after the commit
    rec, seq = recover(str(tmp_path), device="cpu")
    assert seq == live.translog_seq
    _assert_bit_identical(live.inner, rec, Q, "after commit")
    store.close()
