"""GIN (Graph Isomorphism Network, arXiv:1810.00826) -- gin-tu config.

The JAX package's ``models/gnn/gin.py`` in PyTorch.  Three execution
shapes:

* node classification on one big (padded) graph -- full_graph_sm/ogb_products
* sampled-subgraph training (neighbor sampler in sampler.py) -- minibatch_lg
* batched small graphs with sum-readout graph classification -- molecule

GIN update: ``h_i <- MLP_l((1 + eps_l) * h_i + sum_{j in N(i)} h_j)`` with a
learnable eps (gin-tu: eps=learnable, aggregator=sum, 5 layers, d_hidden 64).

The neighbour sum is the reference's ``segment_sum`` over an edge list
(-1 pads).  Here the valid edges are sorted stably by destination once a
forward (:func:`edge_plan`) and every layer sums its bags with
``F.embedding_bag``: each node adds its in-edges in edge order, and the
backward to ``h`` sorts the sources, so a step's bits repeat run to run
-- no atomic ``index_add_`` and no (E, d) message tensor (24.7 GB at
ogbn-products' first layer).  The B small graphs of ``graph_forward``
(the reference vmaps over them) run as one disjoint graph of B * N nodes
with a masked sum readout per graph.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..common import mlp_apply, mlp_init, seeded, softmax_xent
from ..recsys.embedding import bag_plan
from ..tree_module import TreeModule, params_of

__all__ = ["GINConfig", "init_params", "node_forward", "graph_forward",
           "node_loss", "graph_loss", "edge_plan"]


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 1433
    n_classes: int = 16
    learn_eps: bool = True


def init_params(cfg: GINConfig, generator: Optional[torch.Generator] = None,
                device="cuda", seed: int = 0) -> TreeModule:
    generator = seeded(generator, device, seed)
    layers = []
    for i in range(cfg.n_layers):
        din = cfg.d_in if i == 0 else cfg.d_hidden
        layers.append({
            "mlp": mlp_init([din, 2 * cfg.d_hidden, cfg.d_hidden], generator,
                            device=device),
            "eps": torch.zeros((), device=device),
        })
    return TreeModule(cfg, {
        "layers": layers,
        "readout": mlp_init([cfg.d_hidden, cfg.n_classes], generator,
                            device=device),
    })


def edge_plan(src: torch.Tensor, dst: torch.Tensor, n: int):
    """The aggregation plan of an edge list over ``n`` nodes (-1 edges are
    padding): ``F.embedding_bag``'s (indices, offsets) over n + 1 bags,
    the last the sink of the pads."""
    valid = (src >= 0) & (dst >= 0)
    ids, offsets, _ = bag_plan(torch.where(valid, src.long(), 0),
                               torch.where(valid, dst.long(), n), n)
    return ids, offsets


def _aggregate(h: torch.Tensor, plan, n: int) -> torch.Tensor:
    """sum_{j in N(i)} h_j for the n nodes of ``plan``."""
    ids, offsets = plan
    return F.embedding_bag(ids, h, offsets, mode="sum")[:n]


def _layers(p, h, plan, n: int, cfg: GINConfig):
    for layer in p["layers"]:
        agg = _aggregate(h, plan, n)
        eps = layer["eps"] if cfg.learn_eps else 0.0
        h = mlp_apply(layer["mlp"], (1.0 + eps) * h + agg, act="relu",
                      final_act=True)
    return h


def node_forward(params, x, edge_src, edge_dst, cfg: GINConfig):
    """x: (N, F); edges: (E,) src/dst int32 (-1 pad) -> (N, n_classes)."""
    p = params_of(params)
    n = x.shape[0]
    h = _layers(p, x, edge_plan(edge_src, edge_dst, n), n, cfg)
    return mlp_apply(p["readout"], h)


def node_loss(params, batch: Dict, cfg: GINConfig):
    logits = node_forward(params, batch["x"], batch["edge_src"], batch["edge_dst"], cfg)
    return softmax_xent(logits, batch["labels"], batch["label_mask"])


def graph_forward(params, x, edge_src, edge_dst, node_mask, cfg: GINConfig):
    """Batched small graphs: x (B, N, F), edges (B, E) -> (B, n_classes)."""
    p = params_of(params)
    B, N = x.shape[:2]
    base = (torch.arange(B, device=x.device) * N)[:, None]
    valid = (edge_src >= 0) & (edge_dst >= 0)
    src = torch.where(valid, edge_src.long() + base, -1).reshape(-1)
    dst = torch.where(valid, edge_dst.long() + base, -1).reshape(-1)
    n = B * N
    h = _layers(p, x.reshape(n, -1), edge_plan(src, dst, n), n, cfg)
    pooled = (h.reshape(B, N, -1) * node_mask[..., None]).sum(1)   # sum readout
    return mlp_apply(p["readout"], pooled)


def graph_loss(params, batch: Dict, cfg: GINConfig):
    logits = graph_forward(params, batch["x"], batch["edge_src"],
                           batch["edge_dst"], batch["node_mask"], cfg)
    return softmax_xent(logits, batch["labels"])
