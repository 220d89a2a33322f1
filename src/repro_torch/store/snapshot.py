"""Commit points: content-addressed incremental snapshots of the index.

The Lucene side of durability, in the ES *incremental snapshot* model,
in the JAX package's file format (``repro.store.snapshot``) byte for
byte, so either package restores the other's commits.  A commit point is
a generation-numbered manifest (``commit-<gen>.json``) whose atomic
rename IS the commit -- a crash mid-write leaves no manifest, so the
previous commit stays authoritative -- plus the **content-addressed blob
files** the manifest references:

* ``seg-<digest>.seg`` -- one deterministic RSEG container per index
  *part*: the base vectors, the base search state (codes + live), the
  active append buffer, and one blob per sealed
  :class:`~repro_torch.dist.shard_index.Segment`.  The name is the first
  16 hex digits of the sha256 of the blob bytes, so a part whose content
  did not change since the last commit names the SAME file and is only
  *referenced again* -- commits are O(changed parts), not O(index).  RSEG
  is magic + a ``sort_keys`` JSON array directory + raw C-order array
  bytes: equal arrays <=> equal bytes.
* ``commit-<gen>.json`` -- the manifest: translog seqno covered,
  geometry + segment metadata, encoder parameters, and per-blob
  ``{file, crc32, bytes}`` entries.  :func:`latest_commit` walks
  generations newest-first and returns the first whose manifest AND every
  referenced blob checksum verify, so a torn newest commit falls back to
  the previous one.

**Streaming, not joining.**  A blob is never assembled in host memory:
its sha256 and crc32 are taken over the header and each tensor's bytes a
chunk at a time (a card tensor through one pinned 64 MiB staging buffer,
a host tensor through its own memory, sha256 on a second thread beside
the crc32), then, only if no file of that name and length exists, the
same chunks are written to ``<name>.tmp`` and renamed.  A writer's
:class:`_BlobMemo` remembers each blob's entry against the tensors it was
taken from (held by weak reference, with their version counters, which
every in-place write bumps), so the writer's next commit of an index that
shares those tensors re-references the file without reading a byte of
them: a commit's time, not only its bytes, is O(changed).  Restore reads
each array into a tensor it owns (on the card: a chunk at a time through
the staging buffer, one host-to-device copy per chunk).

**Retention + GC**: :func:`write_commit` keeps the newest two manifests
(current + fallback) and then deletes every ``seg-*.seg`` not referenced
by ANY retained manifest -- a blob the fallback commit still references
is never deleted, however old.  The :class:`~repro_torch.store.durable.
Store` serializes commit and recovery on one lock, so a restore in
progress never has a referenced blob unlinked under it.

:func:`restore` rebuilds a :class:`ShardedVectorIndex` on a mesh of S
shards x R replica groups (or at one shard on ``device``).  The base is
stored as the flat rows ``[0, n_docs)`` and splits into S contiguous
shards.  From a writer with S shards every stored leaf of the active
buffer and the segments reloads verbatim; from a writer with another
count (the JAX package on its own mesh, or this package at another
layout) rows re-place by the rules ingest and merge use: active rows by
their append offset (``gid - n_docs - seg_base``) round-robin, sealed rows
by gid rank round-robin, and ``shard_tombstones`` spreads the writer's
total evenly, as the JAX package spreads it.  The posting tables of the
base and of each segment are rebuilt per shard with the live index's own
stable sort, so they are bit-identical to the committed index's.  Derived caches (the int8 tables, ``max_df``) are not stored:
each is rebuilt at first use.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import struct
import weakref
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.encoding import (CombinedEncoder, Encoder,
                                       IntervalEncoder, RoundingEncoder)
from repro_torch.core.search import _SENTINEL
from repro_torch.dist.shard_index import (Segment, ShardedVectorIndex,
                                          _offsets, _partition, _postings,
                                          resolve_mesh)

from .translog import _fsync_dir

__all__ = ["CommitPoint", "write_commit", "latest_commit", "restore",
           "encoder_meta", "encoder_from_meta"]

_FORMAT_VERSION = 2
_MANIFEST_RE = re.compile(r"^commit-(\d{8})\.json$")
_BLOB_RE = re.compile(r"^seg-[0-9a-f]{16}\.seg$")
_BLOB_MAGIC = b"RSEG"
_RETAINED_COMMITS = 2      # current + one fallback (ES keeps the previous
#                            segments_N for exactly this torn-file case)
_CHUNK = 1 << 26           # bytes hashed, written or read per step

# the array dtypes a blob holds, by torch dtype; the directory names them
# by numpy's ``dtype.str`` ("<f4", "|i1", "|b1", ...)
_NUMPY_OF = {t: torch.empty(0, dtype=t).numpy().dtype
             for t in (torch.float32, torch.int8, torch.int16, torch.int32,
                       torch.int64, torch.uint8, torch.bool)}
_TORCH_OF = {v: k for k, v in _NUMPY_OF.items()}


# --------------------------------------------------------- encoder (de)ser
def encoder_meta(enc: Encoder) -> dict:
    if isinstance(enc, RoundingEncoder):
        return {"type": "rounding", "precision": enc.precision}
    if isinstance(enc, IntervalEncoder):
        return {"type": "interval", "width": enc.width}
    if isinstance(enc, CombinedEncoder):
        return {"type": "combined", "rounding": encoder_meta(enc.rounding),
                "interval": encoder_meta(enc.interval)}
    raise TypeError(f"cannot serialize encoder {type(enc).__name__}")


def encoder_from_meta(meta: dict) -> Encoder:
    kind = meta.get("type")
    if kind == "rounding":
        return RoundingEncoder(int(meta["precision"]))
    if kind == "interval":
        return IntervalEncoder(float(meta["width"]))
    if kind == "combined":
        return CombinedEncoder(encoder_from_meta(meta["rounding"]),
                               encoder_from_meta(meta["interval"]))
    raise ValueError(f"unknown encoder meta {meta!r}")


# ------------------------------------------------------------ fs plumbing
def _write_atomic(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def _crc32_file(path: str) -> int:
    """Streaming crc32 -- a blob can be the whole corpus, so it is never
    pulled into memory just to checksum it."""
    crc = 0
    buf = bytearray(_CHUNK)
    view = memoryview(buf)
    with open(path, "rb") as f:
        while True:
            n = f.readinto(buf)
            if not n:
                return crc
            crc = zlib.crc32(view[:n], crc)


def _manifest_path(store_dir: str, gen: int) -> str:
    return os.path.join(store_dir, f"commit-{gen:08d}.json")


def _list_commits(store_dir: str):
    gens = []
    for name in os.listdir(store_dir):
        m = _MANIFEST_RE.match(name)
        if m:
            gens.append(int(m.group(1)))
    return sorted(gens)


# ------------------------------------------------------ RSEG blob container
class _Staging:
    """One pinned host buffer of ``_CHUNK`` bytes, allocated at the first
    card tensor: every device <-> host copy of a blob goes through it."""

    def __init__(self):
        self._buf = None

    def get(self) -> torch.Tensor:
        if self._buf is None:
            self._buf = torch.empty(_CHUNK, dtype=torch.uint8,
                                    pin_memory=True)
        return self._buf


def _flat_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's C-order bytes as a flat uint8 tensor (a view when it is
    contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _tensor_chunks(t: torch.Tensor, staging: _Staging) -> Iterator:
    """Memoryviews over the bytes of ``t``, at most ``_CHUNK`` each.  A
    view is valid until the next one is taken: a card tensor's chunks
    share the staging buffer."""
    flat = _flat_bytes(t)
    n = flat.numel()
    if flat.device.type == "cpu":
        mv = memoryview(flat.numpy())
        for off in range(0, n, _CHUNK):
            yield mv[off:off + _CHUNK]
        return
    buf = staging.get()
    host = memoryview(buf.numpy())
    for off in range(0, n, _CHUNK):
        m = min(_CHUNK, n - off)
        buf[:m].copy_(flat[off:off + m])
        yield host[:m]


def _blob_header(arrays: Dict[str, torch.Tensor]) -> bytes:
    """``RSEG``, the little-endian u32 length of the directory, and the
    ``sort_keys``/no-whitespace JSON directory of ``{name, dtype, shape}``
    entries (insertion order preserved -- it indexes the payload).  No
    timestamps, no compression, no alignment padding: equal arrays give
    equal bytes, which is the whole content-addressing contract."""
    entries = [{"name": name, "dtype": _NUMPY_OF[t.dtype].str,
                "shape": list(t.shape)} for name, t in arrays.items()]
    header = json.dumps({"version": 1, "arrays": entries}, sort_keys=True,
                        separators=(",", ":")).encode()
    return _BLOB_MAGIC + struct.pack("<I", len(header)) + header


def _blob_chunks(header: bytes, arrays: Dict[str, torch.Tensor],
                 staging: _Staging) -> Iterator:
    yield memoryview(header)
    for t in arrays.values():
        yield from _tensor_chunks(t, staging)


def _digest(header, arrays, staging) -> tuple:
    """(sha256 hex, crc32) of the blob, sha256 on a second thread (both
    release the GIL over large buffers)."""
    sha, crc = hashlib.sha256(), 0
    with ThreadPoolExecutor(1) as pool:
        for mv in _blob_chunks(header, arrays, staging):
            job = pool.submit(sha.update, mv)
            crc = zlib.crc32(mv, crc)
            job.result()
    return sha.hexdigest(), crc


def _write_chunks(path, header, arrays, staging) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for mv in _blob_chunks(header, arrays, staging):
            f.write(mv)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


class _BlobMemo:
    """Blob entries already computed, by the identity of the tensors they
    were read from (held by weak reference) and by their version counters,
    which every in-place write bumps.  An entry whose tensors are all alive
    and unwritten is this content: a commit re-references its file without
    reading a byte of them.  One per writer -- :class:`~repro_torch.store.
    durable.Store` keeps one and commits under its lock."""

    def __init__(self):
        self._entries: dict = {}

    @staticmethod
    def _key(names, owners) -> tuple:
        return tuple(names) + tuple(id(t) for t in owners)

    def get(self, names, owners) -> Optional[dict]:
        hit = self._entries.get(self._key(names, owners))
        if hit is None:
            return None
        refs, versions, entry = hit
        if all(r() is t and t._version == v
               for r, t, v in zip(refs, owners, versions)):
            return entry
        return None

    def put(self, names, owners, entry: dict) -> None:
        self._entries[self._key(names, owners)] = (
            tuple(weakref.ref(t) for t in owners),
            tuple(t._version for t in owners), entry)

    def prune(self) -> None:
        """Forget entries whose tensors are gone."""
        self._entries = {k: v for k, v in self._entries.items()
                         if all(r() is not None for r in v[0])}


def _write_blob(store_dir: str, arrays: dict, stats: dict,
                owners=(), memo: Optional[_BlobMemo] = None,
                staging: Optional[_Staging] = None) -> dict:
    """Write (or re-reference) one content-addressed blob -> its manifest
    entry.  ``arrays`` maps names to tensors (or numpy arrays).  An
    existing file with the same digest name and byte length IS this
    content -- the write is skipped and only ``bytes_total`` grows, which
    is the entire sharing mechanism.  ``owners`` are the index tensors the
    arrays are read from, under which ``memo`` remembers the entry."""
    arrays = {name: torch.as_tensor(a) for name, a in arrays.items()}
    staging = staging or _Staging()
    header = _blob_header(arrays)
    size = len(header) + sum(t.numel() * t.element_size()
                             for t in arrays.values())
    stats["bytes_total"] += size
    entry = memo.get(arrays, owners) if memo is not None else None
    if entry is None:
        digest, crc = _digest(header, arrays, staging)
        entry = {"file": f"seg-{digest[:16]}.seg", "crc32": crc,
                 "bytes": size}
        if memo is not None:
            memo.put(arrays, owners, entry)
    path = os.path.join(store_dir, entry["file"])
    if not (os.path.exists(path) and os.path.getsize(path) == size):
        _write_chunks(path, header, arrays, staging)
        stats["bytes_written"] += size
        stats["blobs_written"] += 1
    return dict(entry)


def _read_into(f, flat: torch.Tensor, staging: _Staging, path: str) -> None:
    """Fill the flat uint8 tensor ``flat`` from ``f``: a host tensor
    directly, a card tensor a staging chunk at a time."""
    n = flat.numel()
    if flat.device.type == "cpu":
        mv = memoryview(flat.numpy())
        off = 0
        while off < n:
            got = f.readinto(mv[off:])
            if not got:
                raise ValueError(f"{path!r}: blob ends early")
            off += got
        return
    buf = staging.get()
    host = memoryview(buf.numpy())
    for off in range(0, n, _CHUNK):
        m = min(_CHUNK, n - off)
        got = 0
        while got < m:
            r = f.readinto(host[got:m])
            if not r:
                raise ValueError(f"{path!r}: blob ends early")
            got += r
        flat[off:off + m].copy_(buf[:m])


def _read_blob(path: str, device="cpu",
               staging: Optional[_Staging] = None) -> dict:
    """One RSEG blob -> {name: tensor on ``device``}, each tensor its own
    writable memory."""
    staging = staging or _Staging()
    with open(path, "rb") as f:
        head = f.read(8)
        if head[:4] != _BLOB_MAGIC:
            raise ValueError(f"{path!r} is not an RSEG blob")
        (hlen,) = struct.unpack("<I", head[4:8])
        directory = json.loads(f.read(hlen))
        out = {}
        for e in directory["arrays"]:
            t = torch.empty(tuple(e["shape"]),
                            dtype=_TORCH_OF[np.dtype(e["dtype"])],
                            device=device)
            _read_into(f, _flat_bytes(t), staging, path)
            out[e["name"]] = t
    return out


def _referenced_blobs(meta: dict) -> set:
    files = meta.get("files", {})
    refs = {e["file"] for k, e in files.items()
            if k != "segments" and e is not None}
    refs.update(e["file"] for e in files.get("segments", ()))
    return refs


@dataclasses.dataclass(frozen=True)
class CommitPoint:
    """One verified commit: manifest dict + the store directory holding
    the content-addressed blobs it references."""

    generation: int
    seq: int
    meta: dict
    data_path: str            # the store directory


# ----------------------------------------------------------------- commit
def write_commit(store_dir: str, index: ShardedVectorIndex, seq: int,
                 stats: Optional[dict] = None,
                 memo: Optional[_BlobMemo] = None) -> int:
    """Snapshot ``index`` as the next commit generation covering translog
    seqno ``seq``; returns the generation number.

    Every blob lands (fsync'd, or is already on disk from an earlier
    generation) before the manifest, and the manifest rename is the
    commit: interrupted writes are invisible to :func:`latest_commit`.
    Cost is O(changed parts): the base vectors blob rewrites only after a
    compact, the base state only after base deletes, a sealed segment's
    blob only after deletes hit it, and the active-buffer blob per append
    batch.  ``stats`` (optional dict) receives ``bytes_written`` /
    ``bytes_total`` / ``blobs_written``.  With ``memo`` (the writer's
    :class:`_BlobMemo`), a part whose tensors this writer has committed
    before and nothing has written since is re-referenced unread."""
    os.makedirs(store_dir, exist_ok=True)
    ns, dp = index.n_shards, index.docs_per_shard
    nf, n_docs = index.n_features, index.n_docs
    n_act = index.n_active
    if stats is None:
        stats = {}
    stats.update(bytes_written=0, bytes_total=0, blobs_written=0)
    if memo is not None:
        memo.prune()
    staging = _Staging()

    def blob(arrays, *owners):
        return _write_blob(store_dir, arrays, stats, owners, memo, staging)

    files = {
        "base_vectors": blob({"vectors": index.vectors.reshape(
            ns * dp, nf)[:n_docs]}, index.vectors),
        "base_state": blob({
            "codes": index.codes.reshape(ns * dp, -1)[:n_docs],
            "live": index.live.reshape(ns * dp)[:n_docs]},
            index.codes, index.live),
        "active": None,
        "segments": [],
    }
    if n_act:
        j = np.arange(n_act)
        sg = index.seg_gids.cpu().numpy()
        if not np.array_equal(sg[j % ns, j // ns],
                              n_docs + index.seg_base + j):
            raise ValueError(
                "active-buffer gids violate round-robin routing -- "
                "refusing to write a snapshot that would not restore "
                "bit-identically")
        # the FULL (S, G) leaves, spare sentinel slots included: a
        # same-shard restore then reproduces the leaf bits exactly, and
        # the blob only changes when the buffer content does
        act = (index.seg_vectors, index.seg_codes, index.seg_gids,
               index.seg_live)
        files["active"] = blob(dict(zip(("vectors", "codes", "gids",
                                         "live"), act)), *act)
    for s in index.segments:
        leaves = (s.vectors, s.codes, s.gids, s.live)
        entry = blob(dict(zip(("vectors", "codes", "gids", "live"),
                              leaves)), *leaves)
        entry.update(n_rows=s.n_rows, tombstones=s.tombstones)
        files["segments"].append(entry)

    gens = _list_commits(store_dir)
    gen = (gens[-1] + 1) if gens else 1
    manifest = {
        "format_version": _FORMAT_VERSION,
        "generation": gen,
        "seq": int(seq),
        "n_docs": n_docs,
        "n_appended": index.n_appended,
        "seg_base": index.seg_base,
        "active_tombstones": index.active_tombstones,
        "n_features": nf,
        "code_columns": int(index.codes.shape[-1]),
        "writer_shards": ns,
        "seal_threshold": index.seal_threshold,
        "seg_capacity": index.seg_capacity,
        "shard_tombstones": [int(t) for t in (index.shard_tombstones
                                              or (0,) * ns)],
        "index_best": index.index_best,
        "encoder": encoder_meta(index.encoder),
        "files": files,
        "bytes_written": stats["bytes_written"],
        "bytes_total": stats["bytes_total"],
    }
    _write_atomic(_manifest_path(store_dir, gen),
                  json.dumps(manifest, indent=1).encode())
    _gc_commits(store_dir)
    return gen


def _gc_commits(store_dir: str) -> None:
    """Retention + blob GC: keep the newest ``_RETAINED_COMMITS``
    manifests, then delete every ``seg-*.seg`` no retained manifest
    references.  A retained manifest that fails to parse aborts the sweep:
    deleting blobs while a manifest is unreadable could strand the one
    commit recovery will fall back to."""
    gens = _list_commits(store_dir)
    for old in gens[:-_RETAINED_COMMITS]:
        try:
            os.remove(_manifest_path(store_dir, old))
        except OSError:
            pass
    live: set = set()
    for gen in gens[-_RETAINED_COMMITS:]:
        try:
            with open(_manifest_path(store_dir, gen)) as f:
                live |= _referenced_blobs(json.load(f))
        except (OSError, ValueError):
            return                       # unreadable manifest: skip the GC
    for name in os.listdir(store_dir):
        if _BLOB_RE.match(name) and name not in live:
            try:
                os.remove(os.path.join(store_dir, name))
            except OSError:
                pass


def latest_commit(store_dir: str, *,
                  validate: bool = True) -> Optional[CommitPoint]:
    """Newest commit whose manifest parses AND (with ``validate``, the
    default) whose referenced blobs all match their checksums; earlier
    generations are the fallback.  None if no valid commit.
    ``validate=False`` skips the per-blob CRCs -- for seq-only lookups
    where a full-corpus read per call would be pure waste."""
    if not os.path.isdir(store_dir):
        return None
    for gen in reversed(_list_commits(store_dir)):
        try:
            with open(_manifest_path(store_dir, gen)) as f:
                meta = json.load(f)
            if meta.get("format_version") != _FORMAT_VERSION:
                continue
            entries = ([meta["files"][k] for k in ("base_vectors",
                                                   "base_state", "active")
                        if meta["files"][k] is not None]
                       + list(meta["files"]["segments"]))
            ok = True
            for e in entries:
                path = os.path.join(store_dir, e["file"])
                if validate:
                    ok = (os.path.getsize(path) == e["bytes"]
                          and _crc32_file(path) == e["crc32"])
                else:
                    ok = os.path.exists(path)
                if not ok:
                    break
            if not ok:
                continue
        except (OSError, ValueError, KeyError):
            continue
        return CommitPoint(generation=gen, seq=int(meta["seq"]), meta=meta,
                           data_path=store_dir)
    return None


# ---------------------------------------------------------------- restore
def _replace_rows(part: dict, rank: torch.Tensor, ns: int, width: int,
                  nf: int, n_cols: int, sentinel: int) -> tuple:
    """(S, width, .) leaves holding the used rows of a host blob ``part``
    (gid >= 0, in blob order), the row of rank ``r`` in slot ``r // S`` of
    shard ``r % S``; spare slots are sentinel-coded, gid -1, dead."""
    rows = part["gids"].reshape(-1) >= 0
    cdtype = part["codes"].dtype
    mv = torch.zeros((ns, width, nf))
    mc = torch.full((ns, width, n_cols), sentinel, dtype=cdtype)
    mg = torch.full((ns, width), -1, dtype=torch.int32)
    ml = torch.zeros((ns, width), dtype=torch.bool)
    sh, sl = rank % ns, rank // ns
    mv[sh, sl] = part["vectors"].reshape(-1, nf)[rows]
    mc[sh, sl] = part["codes"].reshape(-1, n_cols)[rows]
    mg[sh, sl] = part["gids"].reshape(-1)[rows]
    ml[sh, sl] = part["live"].reshape(-1)[rows]
    return mv, mc, mg, ml


def _pad_rows(t: torch.Tensor, pad: int, value) -> torch.Tensor:
    if not pad:
        return t
    return torch.cat([t, t.new_full((pad,) + tuple(t.shape[1:]), value)])


def restore(commit: CommitPoint, device=None, *,
            mesh=None) -> ShardedVectorIndex:
    """Rebuild the index of ``commit`` on ``mesh`` (S shards x R replica
    groups), or at one shard on ``device`` (the card when neither is
    given).

    From a writer of S shards every stored leaf reloads verbatim, so each
    is bit-identical to the committed index's.  From a writer of another
    shard count, rows re-place on the host by the rules ingest and merge
    use (active rows by append offset, sealed rows by gid rank) and each
    leaf is copied to the device once.  Posting tables (base + per-segment)
    are rebuilt per shard by the live index's own stable sort."""
    mesh = resolve_mesh(mesh, device)
    device = mesh.device
    meta = commit.meta
    store_dir = commit.data_path
    files = meta["files"]
    staging = _Staging()

    def blob(entry, dev=device):
        return _read_blob(os.path.join(store_dir, entry["file"]), dev,
                          staging)

    n_docs, n_app = int(meta["n_docs"]), int(meta["n_appended"])
    seg_base = int(meta["seg_base"])
    n_act = n_app - seg_base
    nf, C = int(meta["n_features"]), int(meta["code_columns"])
    encoder = encoder_from_meta(meta["encoder"])
    ns = mesh.n_shards
    dp, pad = _partition(n_docs, ns)
    same_shards = int(meta["writer_shards"]) == ns

    # the base: the blob's rows split into contiguous shards, the last
    # padded with zero rows, sentinel codes and live=False
    vectors = _pad_rows(blob(files["base_vectors"])["vectors"], pad, 0.0)
    base_state = blob(files["base_state"])
    cdtype = base_state["codes"].dtype
    sentinel = _SENTINEL[cdtype]
    codes = _pad_rows(base_state["codes"], pad, sentinel).view(ns, dp, C)
    live = _pad_rows(base_state["live"], pad, False).view(ns, dp)
    vectors = vectors.view(ns, dp, nf)
    pdocs, pcodes = _postings(codes)

    # ----- active append buffer
    if files["active"] is not None and same_shards:
        act = blob(files["active"])        # leaf-level bit-identity
        active = [act[k] for k in ("vectors", "codes", "gids", "live")]
    elif n_act:
        # a fresh geometric ladder, as one add_documents from empty
        # would allocate; the j-th doc appended since the last seal sits
        # in slot j // S of shard j % S
        act = blob(files["active"], "cpu")
        gids = act["gids"].reshape(-1)
        j = gids[gids >= 0].long() - n_docs - seg_base
        active = [t.to(device) for t in _replace_rows(
            act, j, ns, max(-(-n_act // ns), 8), nf, C, sentinel)]
    else:
        e = ShardedVectorIndex._empty_active(ns, nf, C, cdtype, device)
        active = [e[k] for k in ("seg_vectors", "seg_codes", "seg_gids",
                                 "seg_live")]

    # ----- sealed segments
    segments = []
    for e in files["segments"]:
        if same_shards:
            part = blob(e)
            leaves = [part[k] for k in ("vectors", "codes", "gids", "live")]
        else:
            # sealed rows re-place by gid rank -- the rule both sealing
            # (contiguous gids) and merging (id-order re-pack) produce
            part = blob(e, "cpu")
            gids = part["gids"].reshape(-1)
            rank = torch.argsort(torch.argsort(gids[gids >= 0],
                                               stable=True))
            leaves = [t.to(device) for t in _replace_rows(
                part, rank, ns, -(-int(e["n_rows"]) // ns), nf, C,
                sentinel)]
        segments.append(Segment(*leaves, *_postings(leaves[1]),
                                n_rows=int(e["n_rows"]),
                                tombstones=int(e["tombstones"])))

    # advisory per-shard deletion history: the writer's own, or its total
    # spread evenly over another shard count
    stones = [int(t) for t in meta["shard_tombstones"]]
    if not same_shards:
        total = sum(stones)
        stones = [total // ns + (i < total % ns) for i in range(ns)]
    if not any(stones):
        stones = []                         # the fresh-index spelling

    seal = meta["seal_threshold"]
    return ShardedVectorIndex(
        vectors=vectors, codes=codes, post_docs=pdocs, post_codes=pcodes,
        offsets=_offsets(ns, dp, device), live=live,
        seg_vectors=active[0], seg_codes=active[1], seg_gids=active[2],
        seg_live=active[3],
        segments=tuple(segments),
        encoder=encoder,
        n_docs=n_docs,
        index_best=meta["index_best"],
        n_appended=n_app,
        shard_tombstones=tuple(stones),
        seal_threshold=None if seal is None else int(seal),
        seg_base=seg_base,
        active_tombstones=int(meta["active_tombstones"]),
        mesh=mesh,
    )
