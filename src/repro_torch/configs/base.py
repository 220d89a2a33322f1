"""Config layer: the architecture records of the LM, GNN and recsys
families.

``LMArch`` holds an architecture's full config, its optimizer, the input
shapes it is measured at (``SHAPES``, the reference's table), the shapes
it skips, an ``accum`` override and the reduced ``smoke()`` config.
``GNNArch`` holds gin-tu's base config and resolves it per input shape
(``cfg_for``); ``RecsysArch`` holds a recsys model's config, its init,
forward and user-tower functions and its reduced ``smoke_cfg``.  The
reference's ``cell()`` (a step function with abstract arguments and
PartitionSpecs for the pod dry-run) belongs to the dry-run slice (ROADMAP
Queue 1 item 9, slice 17).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from repro_torch.models.gnn import gin
from repro_torch.models.transformer.model import LMConfig


class LMArch:
    family = "lm"
    SHAPES = {
        # accum=8: microbatched grad accumulation keeps the (B, S, V) logits
        # tensor at 1/8 size
        "train_4k": dict(kind="train", seq=4096, batch=256, accum=8),
        "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
        "decode_32k": dict(kind="decode", seq=32768, batch=128),
        "long_500k": dict(kind="decode", seq=524288, batch=1, seq_sharded=True),
    }

    def __init__(self, cfg: LMConfig, optimizer: str = "adamw",
                 skip_shapes: Tuple[str, ...] = (), smoke_cfg=None,
                 accum: Optional[int] = None):
        self.cfg = cfg
        self.optimizer = optimizer
        self.skip_shapes = skip_shapes
        self._smoke = smoke_cfg
        self.accum = accum              # override SHAPES accum (MoE memory)

    def smoke(self):
        return self._smoke


# ===================================================================== GNN
def _pad512(n: int) -> int:
    return ((n + 511) // 512) * 512


class GNNArch:
    family = "gnn"
    # (d_feat, n_classes, nodes, edges) per shape; padded to /512 so the
    # fixed meshes shard evenly (pads are masked: -1 edges, 0 label_mask).
    SHAPES = {
        "full_graph_sm": dict(kind="train", mode="node", d_in=1433, classes=7,
                              nodes=_pad512(2708), edges=_pad512(10556)),
        "minibatch_lg": dict(kind="train", mode="node", d_in=602, classes=41,
                             nodes=_pad512(1024 + 1024 * 15 + 1024 * 150),
                             edges=_pad512(1024 * 15 + 1024 * 150)),
        "ogb_products": dict(kind="train", mode="node", d_in=100, classes=47,
                             nodes=_pad512(2_449_029), edges=_pad512(61_859_140)),
        "molecule": dict(kind="train", mode="graph", d_in=16, classes=2,
                         batch=128, nodes=30, edges=64),
    }

    def __init__(self, base_cfg: gin.GINConfig):
        self.base_cfg = base_cfg

    def cfg_for(self, shape_name: str) -> gin.GINConfig:
        info = self.SHAPES[shape_name]
        return dataclasses.replace(
            self.base_cfg, d_in=info["d_in"], n_classes=info["classes"]
        )


# =================================================================== RecSys
class RecsysArch:
    family = "recsys"
    SHAPES = {
        "train_batch": dict(kind="train", batch=65536),
        "serve_p99": dict(kind="serve", batch=512),
        "serve_bulk": dict(kind="serve", batch=262144),
        "retrieval_cand": dict(kind="retrieval", batch=1, n_cand=1_000_000),
    }

    def __init__(self, cfg, init_fn: Callable, forward_fn: Callable,
                 user_fn: Callable, seq: bool):
        self.cfg = cfg
        self.init_fn = init_fn
        self.forward_fn = forward_fn
        self.user_fn = user_fn
        self.seq = seq                      # DIN/BST style history batches
        self.smoke_cfg = None               # set by the arch's config module
