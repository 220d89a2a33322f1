"""Crash recovery: latest commit point + translog replay.

The ES shard-recovery sequence (``index.recovery`` after a node restart):
open the newest Lucene commit, then replay every translog operation past
the commit's sequence number.  Here the same two phases run against the
store directory:

1. :func:`repro_torch.store.snapshot.latest_commit` picks the newest
   commit whose manifest and blob checksums verify (falling back to
   earlier generations past a torn newest commit), and
   :func:`~repro_torch.store.snapshot.restore` rebuilds it on the mesh
   (or at one shard on ``device``);
2. :func:`repro_torch.store.translog.read_ops` replays records with
   ``seq > commit.seq`` -- torn tails are truncated, checksummed records
   are applied through the SAME ``add_documents``/``delete`` code paths
   the live ingest ran, on the same layout.  Replay re-runs the identical
   normalize/encode on the identical logged inputs -- and re-SEALS
   append segments at identical boundaries, because sealing is a pure
   function of the op history -- so the recovered index is bit-identical
   to the one that was lost, leaf for leaf and answer for answer (pinned
   by tests/test_torch_store.py at every ingest/delete/merge/compact
   boundary, all six engines).

A commit gap (oldest surviving translog record is newer than
``commit.seq + 1``) raises :class:`TranslogCorruptedError` rather than
silently recovering a hole in the acked history.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.dist.shard_index import ShardedVectorIndex

from .snapshot import latest_commit, restore
from .translog import OP_ADD, OP_DELETE, TranslogCorruptedError, read_ops

__all__ = ["recover", "NoCommitError"]


class NoCommitError(FileNotFoundError):
    """The store directory holds no valid commit point to recover from."""


def _clock(device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.monotonic()


def recover(store_dir: str, device=None, stats: Optional[dict] = None, *,
            mesh=None) -> Tuple[ShardedVectorIndex, int]:
    """Rebuild the index from disk on ``mesh`` (S shards x R replica
    groups), or at one shard on ``device`` (the card when neither is
    given) -> (index, last seqno).

    The commit may come from a writer with any shard count (see
    :func:`repro_torch.store.snapshot.restore`); the returned seqno is
    what a new commit covering this state should record.  ``stats``
    (optional dict) receives the seconds of each step (``validate_s``,
    ``restore_s``, ``replay_s``, the device synchronised at each step's
    end) and the replayed ``replay_ops`` and ``replay_rows``."""
    t0 = time.monotonic()
    commit = latest_commit(store_dir)
    if commit is None:
        raise NoCommitError(f"no valid commit point in {store_dir!r}")
    t1 = time.monotonic()
    index = restore(commit, device, mesh=mesh)
    t2 = _clock(index.device) if stats is not None else 0.0
    seq, ops, rows = commit.seq, 0, 0
    for rec_seq, op, payload in read_ops(store_dir, after_seq=seq,
                                         truncate_torn=True):
        if op == OP_ADD:
            index = index.add_documents(payload)
            rows += np.atleast_2d(payload).shape[0]
        elif op == OP_DELETE:
            index = index.delete(payload)
        else:
            raise TranslogCorruptedError(
                f"unknown translog op {op} at seq {rec_seq}")
        seq, ops = rec_seq, ops + 1
    if stats is not None:
        stats.update(validate_s=t1 - t0, restore_s=t2 - t1,
                     replay_s=_clock(index.device) - t2, replay_ops=ops,
                     replay_rows=rows)
    return index, seq
