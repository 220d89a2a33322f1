"""Faults planted under the timed path, to show that the comparison
catches them: each wraps a served index so that its ``search`` answers
wrongly, and every add and merge (the writes the cells make) returns a
wrapped index, so the fault survives the index's swaps.

* ``answer_altered``: the best hit of each query is replaced by another
  document (its reported score kept);
* ``half_batch``: only the first half of each batch's queries (its
  non-zero rows, rounded down) is searched, the rest answered with
  nothing;
* ``exchange_left_out``: each query sees only doc-shard 0 (the pages of
  the other shards are never gathered);
* ``none``: no fault.
"""

from __future__ import annotations

import torch

FAULTS = ("none", "answer_altered", "half_batch", "exchange_left_out")


class Faulty:
    def __init__(self, inner, fault: str):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.inner, self.fault = inner, fault

    def _wrap(self, out):
        return Faulty(out, self.fault)

    def add_documents(self, vectors, **kwargs):
        return self._wrap(self.inner.add_documents(vectors, **kwargs))

    def merge_segments(self, start: int = 0, count=None):
        return self._wrap(self.inner.merge_segments(start, count))

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def search(self, queries, **kwargs):
        if self.fault == "half_batch":
            q = torch.as_tensor(queries)
            real = int((q.abs().sum(-1) > 0).sum())
            h = max(1, real // 2)
            ids, scores = self.inner.search(q[:h], **kwargs)
            if real < 2:
                ids, scores = ids.fill_(-1), scores.fill_(float("-inf"))
            pad = q.shape[0] - h
            ids = torch.cat([ids, ids.new_full((pad, ids.shape[1]), -1)])
            scores = torch.cat([scores, scores.new_full(
                (pad, scores.shape[1]), float("-inf"))])
            return ids, scores
        if self.fault == "exchange_left_out":
            return _shard0(self.inner).search(queries, **kwargs)
        ids, scores = self.inner.search(queries, **kwargs)
        if self.fault == "answer_altered":
            ids = ids.clone()
            ids[:, 0] = (ids[:, 0] + 1) % max(int(self.inner.n_docs), 2)
        return ids, scores


def _shard0(index):
    """A one-shard view of a doc-sharded index: shard 0's base alone."""
    import dataclasses

    from repro_torch.launch.mesh import make_shard_mesh

    if not hasattr(index, "offsets") or index.n_shards == 1:
        return index
    dev = index.device
    return dataclasses.replace(
        index, vectors=index.vectors[:1], codes=index.codes[:1],
        post_docs=index.post_docs[:1], post_codes=index.post_codes[:1],
        offsets=index.offsets[:1], live=index.live[:1],
        seg_vectors=index.seg_vectors[:1], seg_codes=index.seg_codes[:1],
        seg_gids=index.seg_gids[:1], seg_live=index.seg_live[:1],
        segments=(), shard_tombstones=(),
        mesh=make_shard_mesh(1, 1, device=dev))
