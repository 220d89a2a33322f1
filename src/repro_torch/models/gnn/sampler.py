"""Host-side uniform neighbor sampler (GraphSAGE-style) for minibatch_lg.

Produces fixed-shape padded subgraph blocks (one shape a run): for
fanouts ``(f1, f2)`` and ``B`` seed nodes the block holds at most
``B + B*f1 + B*f1*f2`` nodes.  The sampler runs on host numpy from a CSR
adjacency (the data-pipeline side of the system); the device-side train step
consumes the padded block like any other graph.

A copy of the JAX package's ``models/gnn/sampler.py`` (host numpy only):
the same graph and ``rng`` give byte-identical blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

__all__ = ["CSRGraph", "build_csr", "sample_block", "block_capacity"]


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    indptr: np.ndarray   # (N+1,)
    indices: np.ndarray  # (E,)
    feats: np.ndarray    # (N, F)
    labels: np.ndarray   # (N,)


def build_csr(n_nodes: int, edge_src: np.ndarray, edge_dst: np.ndarray,
              feats: np.ndarray, labels: np.ndarray) -> CSRGraph:
    order = np.argsort(edge_dst, kind="stable")
    src_sorted = edge_src[order]
    dst_sorted = edge_dst[order]
    indptr = np.searchsorted(dst_sorted, np.arange(n_nodes + 1))
    return CSRGraph(indptr.astype(np.int64), src_sorted.astype(np.int32),
                    feats, labels)


def block_capacity(batch_nodes: int, fanouts: Tuple[int, ...]) -> Tuple[int, int]:
    """-> (max_nodes, max_edges) of a sampled block."""
    n, nodes, edges = batch_nodes, batch_nodes, 0
    for f in fanouts:
        edges += n * f
        n = n * f
        nodes += n
    return nodes, edges


def sample_block(
    g: CSRGraph, seeds: np.ndarray, fanouts: Tuple[int, ...],
    rng: np.random.Generator,
) -> Dict[str, np.ndarray]:
    """Uniform k-hop neighbor sampling -> padded block arrays.

    Returns locally-indexed ``edge_src/edge_dst`` (-1 padded), node features
    ``x`` for all block nodes, seed ``labels`` and a ``seed_mask``.
    """
    max_nodes, max_edges = block_capacity(len(seeds), fanouts)
    node_ids = list(seeds)
    local = {int(s): i for i, s in enumerate(seeds)}
    e_src, e_dst = [], []
    frontier = list(seeds)
    for f in fanouts:
        nxt = []
        for u in frontier:
            lo, hi = g.indptr[u], g.indptr[u + 1]
            deg = hi - lo
            if deg == 0:
                continue
            picks = g.indices[lo + rng.integers(0, deg, size=min(f, int(deg)))]
            for v in picks:
                v = int(v)
                if v not in local:
                    local[v] = len(node_ids)
                    node_ids.append(v)
                    nxt.append(v)
                e_src.append(local[v])
                e_dst.append(local[u])
        frontier = nxt

    node_ids = np.asarray(node_ids[:max_nodes], np.int64)
    n, e = len(node_ids), len(e_src)
    x = np.zeros((max_nodes, g.feats.shape[1]), g.feats.dtype)
    x[:n] = g.feats[node_ids]
    src = np.full(max_edges, -1, np.int32)
    dst = np.full(max_edges, -1, np.int32)
    src[:e] = np.asarray(e_src[:max_edges], np.int32)
    dst[:e] = np.asarray(e_dst[:max_edges], np.int32)
    labels = np.zeros(max_nodes, np.int32)
    labels[: len(seeds)] = g.labels[seeds]
    mask = np.zeros(max_nodes, np.float32)
    mask[: len(seeds)] = 1.0
    return {"x": x, "edge_src": src, "edge_dst": dst,
            "labels": labels, "label_mask": mask}
