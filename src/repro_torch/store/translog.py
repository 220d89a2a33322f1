"""Write-ahead translog for ingest durability (the ES transaction log).

Elasticsearch acks an index/delete request only after the operation is in
the shard's *translog* (``index.translog.durability``), because the Lucene
segments it will eventually live in are flushed far less often.  This
module is that log for the sharded vector index: an append-only file of
framed, checksummed, sequence-numbered records -- one per
``add_documents``/``delete`` operation -- fsync'd per a configurable
durability policy, written after the op applied in memory but BEFORE the
caller is acked (ES's order: a raising op is never logged, see
:class:`repro_torch.store.durable.DurableIndex`).

One deliberate deviation from ES: the log is *operation*-scoped, not
per-shard.  ES needs a log per shard because each shard is an independent
Lucene index with independent routing; here ingest routing is a pure
function of the global append counter (round-robin, see
``ShardedVectorIndex._seg_slots_used``), so replaying the single global
operation stream reproduces every shard's state bit for bit -- on ANY
shard count, which is what lets a commit the JAX package wrote on an
SxR mesh restore onto this package's one shard.  The format is the JAX
package's (``repro.store.translog``) byte for byte: the same ops give
the same generation files, and each package reads the other's.

On-disk layout (ES translog generations): ``translog-<gen>.log`` files,
each ``MAGIC + version`` then records

    [crc32 u32][seq u64][op u8][payload_len u32][payload bytes]

where ``crc32`` covers everything after itself.  A *torn tail* (crash
mid-append: short header, short payload, or checksum mismatch at the end
of the newest generation) is detected and truncated on recovery; a bad
record anywhere else is real corruption and raises
:class:`TranslogCorruptedError`.  Commits roll the writer onto a fresh
generation and delete generations wholly covered by the commit point
(:meth:`Translog.roll` / :meth:`Translog.trim` -- ES
``translog.retention`` after a flush).

Durability policies (ES ``index.translog.durability``):

* ``"request"`` (default) -- flush + fsync before the append returns: an
  acked op survives a process kill AND a power loss.
* ``"async"`` -- buffered write only; fsync happens at ``sync``/``roll``/
  ``close``.  An acked op survives a process kill (the OS holds the
  bytes) but a power loss may lose the tail -- the replay path treats the
  missing tail as torn and recovers to the last durable prefix.
"""

from __future__ import annotations

import io
import os
import re
import struct
import threading
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["Translog", "TranslogCorruptedError", "OP_ADD", "OP_DELETE",
           "read_ops"]

_MAGIC = b"RTLG"
_VERSION = 1
_HEADER = _MAGIC + bytes([_VERSION])
_BASE = struct.Struct("<Q")              # header trailer: base seqno -- the
#   seq of the last record BEFORE this generation, so an empty rolled
#   generation still anchors the writer's next seqno after a trim (the ES
#   translog.ckpt checkpoint, folded into the file header)
_REC = struct.Struct("<IQBI")            # crc32, seq, op, payload_len
_GEN_RE = re.compile(r"^translog-(\d{8})\.log$")

OP_ADD = 1                               # payload: (m, n_feat) f32 vectors
OP_DELETE = 2                            # payload: (m,) i64 global ids

_DURABILITIES = ("request", "async")


class TranslogCorruptedError(RuntimeError):
    """A record failed its checksum somewhere OTHER than the torn tail of
    the newest generation (which is a normal crash artefact and silently
    truncated) -- the log cannot be trusted past this point."""


def _encode(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def _decode(payload: bytes) -> np.ndarray:
    return np.load(io.BytesIO(payload), allow_pickle=False)


def _fsync_dir(path: str) -> None:
    """Persist directory entries: a created (or unlinked) generation file
    is durable only once its dirent is -- fsync of the file alone does
    not survive a power loss of the directory block."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _gen_path(dirpath: str, gen: int) -> str:
    return os.path.join(dirpath, f"translog-{gen:08d}.log")


def _list_generations(dirpath: str) -> List[int]:
    gens = []
    for name in os.listdir(dirpath):
        m = _GEN_RE.match(name)
        if m:
            gens.append(int(m.group(1)))
    return sorted(gens)


def _gen_base(path: str) -> int:
    """The generation's base seqno (last seq issued before it opened)."""
    with open(path, "rb") as f:
        header = f.read(len(_HEADER) + _BASE.size)
    if len(header) < len(_HEADER) + _BASE.size or \
            header[: len(_HEADER)] != _HEADER:
        raise TranslogCorruptedError(f"{path}: bad translog header")
    return _BASE.unpack_from(header, len(_HEADER))[0]


def _read_gen(path: str, *, tolerate_torn: bool,
              truncate: bool) -> Iterator[Tuple[int, int, bytes]]:
    """Yield ``(seq, op, payload)`` from one generation file.

    A torn tail (short/garbled trailing record) is tolerated only when
    ``tolerate_torn`` -- and physically truncated when ``truncate`` -- so
    that the invariant "damage only ever sits at the very end of the
    newest generation" survives the repair."""
    _gen_base(path)                                 # header sanity
    with open(path, "rb") as f:
        f.seek(len(_HEADER) + _BASE.size)
        torn_at: Optional[int] = None
        while True:
            pos = f.tell()
            head = f.read(_REC.size)
            if not head:
                return                              # clean EOF
            if len(head) < _REC.size:
                torn_at = pos
                break
            crc, seq, op, plen = _REC.unpack(head)
            payload = f.read(plen)
            if len(payload) < plen or crc != zlib.crc32(head[4:] + payload):
                torn_at = pos
                break
            yield seq, op, payload
    if not tolerate_torn:
        raise TranslogCorruptedError(
            f"{path}: corrupt record at byte {torn_at} (not the newest "
            "generation's tail -- refusing to replay past it)")
    if truncate:
        with open(path, "r+b") as f:
            f.truncate(torn_at)


def _scan(dirpath: str, *, truncate_torn: bool,
          ) -> Iterator[Tuple[int, int, bytes]]:
    """Every record across all generations, in order, with consecutive
    records checked for seqno contiguity (appends are strictly sequential,
    and trims only ever remove a covered PREFIX of generations, so any
    in-stream gap is corruption)."""
    gens = _list_generations(dirpath)
    prev = None
    for i, gen in enumerate(gens):
        last = i == len(gens) - 1
        path = _gen_path(dirpath, gen)
        try:
            _gen_base(path)
        except TranslogCorruptedError:
            if last:
                # torn HEADER (crash mid-roll, before the first record):
                # an empty newest generation -- the previous generations
                # still hold the whole durable history
                return
            raise
        for seq, op, payload in _read_gen(
                path, tolerate_torn=last, truncate=last and truncate_torn):
            if prev is not None and seq != prev + 1:
                raise TranslogCorruptedError(
                    f"translog gap: seq {prev} followed by {seq} in "
                    f"generation {gen}")
            prev = seq
            yield seq, op, payload


def read_ops(dirpath: str, after_seq: int = 0, *, truncate_torn: bool = True,
             ) -> Iterator[Tuple[int, int, np.ndarray]]:
    """Replay ``(seq, op, payload array)`` for every record with
    ``seq > after_seq``, generations in order.

    The first record past ``after_seq`` must be ``after_seq + 1`` unless
    its predecessors are still on disk -- a hole between the commit point
    and the replayable history means a lost generation and raises
    :class:`TranslogCorruptedError` (replaying around it would silently
    diverge from the acked history).  Only the newest generation may carry
    a torn tail; it is truncated in place when ``truncate_torn`` (the
    crash-recovery default).
    """
    first = True
    for seq, op, payload in _scan(dirpath, truncate_torn=truncate_torn):
        if first and seq > after_seq + 1:
            raise TranslogCorruptedError(
                f"translog gap: oldest record on disk is seq {seq} but the "
                f"commit point covers only up to {after_seq}")
        first = False
        if seq <= after_seq:
            continue
        yield seq, op, _decode(payload)


class Translog:
    """Append-only writer over the generation files in ``dirpath``.

    Opening recovers crash state first (truncates the newest generation's
    torn tail, re-reads the last durable seqno) and then starts a FRESH
    generation, so the writer never appends into a file another process's
    crash may have damaged mid-record.  Thread-safe: appends serialize on
    an internal lock (the engine lock already serializes ingest, this is
    defence in depth for direct users).
    """

    def __init__(self, dirpath: str, durability: str = "request"):
        if durability not in _DURABILITIES:
            raise ValueError(
                f"durability must be one of {_DURABILITIES}, got "
                f"{durability!r}")
        os.makedirs(dirpath, exist_ok=True)
        self.dirpath = dirpath
        self.durability = durability
        self._lock = threading.Lock()
        self._seq = 0
        gens = _list_generations(dirpath)
        if gens:
            # a torn HEADER on the newest generation is a crash mid-roll
            # artifact: no record can exist past an incomplete header, so
            # DELETE the file.  Merely skipping it would brick the log:
            # once this writer's new generation holds records, the torn
            # file would no longer be "newest" and every later scan would
            # treat its bad header as hard corruption.
            newest = _gen_path(dirpath, gens[-1])
            try:
                _gen_base(newest)
            except TranslogCorruptedError:
                os.remove(newest)
                _fsync_dir(dirpath)
                gens.pop()
        if gens:
            # establish the durable seqno; the newest generation's torn
            # TAIL (if any) is truncated as a side effect
            for seq, _, _ in _scan(dirpath, truncate_torn=True):
                self._seq = seq
            # an empty (just-rolled, trimmed) generation anchors the seqno
            # through its header base instead of through records
            self._seq = max(self._seq, _gen_base(_gen_path(dirpath,
                                                           gens[-1])))
        self._gen = (gens[-1] + 1) if gens else 1
        self._file = self._open_gen()

    def _open_gen(self):
        f = open(_gen_path(self.dirpath, self._gen), "ab")
        f.write(_HEADER + _BASE.pack(self._seq))
        f.flush()
        os.fsync(f.fileno())
        _fsync_dir(self.dirpath)    # the dirent too, or "request"-durable
        #                             records could vanish with the file
        return f

    # ------------------------------------------------------------------ API
    @property
    def seqno(self) -> int:
        """Last assigned sequence number (0 = nothing ever logged)."""
        with self._lock:
            return self._seq

    @property
    def generation(self) -> int:
        return self._gen

    def append(self, op: int, arr: np.ndarray) -> int:
        """Frame + append one record; returns its sequence number.  Under
        ``durability="request"`` the record is fsync'd before this
        returns -- the caller may ack."""
        payload = _encode(arr)
        with self._lock:
            if self._file.closed:
                raise RuntimeError("translog closed")
            self._seq += 1
            body = struct.pack("<QBI", self._seq, op, len(payload)) + payload
            self._file.write(struct.pack("<I", zlib.crc32(body)) + body)
            self._file.flush()
            if self.durability == "request":
                os.fsync(self._file.fileno())
            return self._seq

    def add(self, vectors) -> int:
        """Log an ``add_documents`` op (the RAW input vectors: replay runs
        the identical normalize/encode the live ingest ran, which is what
        makes recovery bit-exact)."""
        return self.append(OP_ADD, np.asarray(vectors, np.float32))

    def delete(self, ids) -> int:
        return self.append(OP_DELETE, np.asarray(ids, np.int64))

    def sync(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.flush()
                os.fsync(self._file.fileno())

    def roll(self) -> int:
        """Fsync + close the current generation and start a fresh one (ES
        rolls the translog generation at every flush/commit)."""
        with self._lock:
            self._file.flush()
            os.fsync(self._file.fileno())
            self._file.close()
            self._gen += 1
            self._file = self._open_gen()
            return self._gen

    def trim(self, upto_seq: int) -> int:
        """Delete non-current generations whose every record is covered by
        a commit point at ``upto_seq``; returns files removed.  Trailing
        generations are never skipped past a retained one, so the on-disk
        set stays a contiguous suffix of history."""
        removed = 0
        with self._lock:
            for gen in _list_generations(self.dirpath):
                if gen == self._gen:
                    continue
                path = _gen_path(self.dirpath, gen)
                try:
                    seqs = [s for s, _, _ in _read_gen(
                        path, tolerate_torn=False, truncate=False)]
                except TranslogCorruptedError:
                    break                # damaged: keep for forensics
                if seqs and max(seqs) > upto_seq:
                    break                # first uncovered generation: stop
                os.remove(path)
                removed += 1
            if removed:
                _fsync_dir(self.dirpath)
        return removed

    def close(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.flush()
                os.fsync(self._file.fileno())
                self._file.close()
