"""Embedding substrate for recsys: field lookups and EmbeddingBag.

The JAX package's ``models/recsys/embedding.py``: tables are one flat
``(sum_f V_f, D)`` matrix with per-field offsets (the row-sharded DLRM
layout).  Rows are looked up with ``F.embedding`` and bags reduced with
``F.embedding_bag``, never by tensor indexing or ``index_add_``: their
CUDA backwards sort the ids and add each row's gradient in a fixed
order, where indexing's backward accumulates with atomics, so two runs
of a step would not give the same bits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..common import div, embed_init

__all__ = ["flat_table_init", "field_lookup", "embedding_bag",
           "embedding_bag_segment", "field_offsets", "bag_plan"]


def field_offsets(vocab_sizes: Sequence[int]) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]]).astype(np.int32)


def flat_table_init(vocab_sizes: Sequence[int], dim: int,
                    generator: Optional[torch.Generator] = None,
                    device="cuda") -> torch.Tensor:
    total = int(np.sum(vocab_sizes))
    return embed_init((total, dim), generator, device=device)


def field_lookup(table: torch.Tensor, ids: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """Single-hot per-field lookup: ids (B, F) -> (B, F, D).  A 1-D table
    (xDeepFM's ``linear``) is looked up as its (V, 1) view -> (B, F)."""
    flat = ids.long() + offsets[None, :].long()
    if table.ndim == 1:
        return F.embedding(flat, table[:, None])[..., 0]
    return F.embedding(flat, table)


def embedding_bag(
    table: torch.Tensor,      # (V, D)
    ids: torch.Tensor,        # (B, L) int (multi-hot bag; < 0 = pad)
    weights: torch.Tensor,    # (B, L) f32 per-sample weights / mask
    mode: str = "sum",        # sum | mean
) -> torch.Tensor:
    """torch.nn.EmbeddingBag with the reference's pads: ids < 0 weigh 0,
    and ``mean`` divides by max(sum of the weights, 1e-9)."""
    valid = ids >= 0
    w = torch.where(valid, weights.float(), 0.0)
    out = F.embedding_bag(torch.where(valid, ids.long(), 0), table,
                          per_sample_weights=w, mode="sum")
    if mode == "mean":
        out = div(out, torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9))
    return out


def embedding_bag_segment(
    table: torch.Tensor,        # (V, D)
    flat_ids: torch.Tensor,     # (nnz,) int
    segment_ids: torch.Tensor,  # (nnz,) int bag index per id
    n_bags: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """CSR-style EmbeddingBag: each row of ``flat_ids`` (times its weight)
    summed into bag ``segment_ids``; ids < 0 and bags outside [0,
    n_bags) add nothing.  The entries are sorted by bag (stably) and
    reduced by ``F.embedding_bag`` over offsets, so a bag's sum runs in
    entry order, as a segment sum's."""
    valid = (flat_ids >= 0) & (segment_ids >= 0) & (segment_ids < n_bags)
    ids, offsets, order = bag_plan(torch.where(valid, flat_ids.long(), 0),
                                   torch.where(valid, segment_ids.long(), n_bags),
                                   n_bags)
    w = None if weights is None else weights.float()[order]
    return F.embedding_bag(ids, table, offsets, mode="sum",
                           per_sample_weights=w)[:n_bags]


def bag_plan(ids: torch.Tensor, bags: torch.Tensor, n_bags: int):
    """Entries (``ids``, ``bags``), bags in [0, n_bags] -> the (ids,
    offsets, order) of ``F.embedding_bag`` over n_bags + 1 bags: entries
    sorted stably by bag, so each bag keeps its entries' order, and the
    last bag, ``n_bags``, the sink of the entries that add nothing."""
    bags, order = torch.sort(bags, stable=True)
    offsets = torch.searchsorted(
        bags, torch.arange(n_bags + 1, device=bags.device))
    return ids[order], offsets, order
