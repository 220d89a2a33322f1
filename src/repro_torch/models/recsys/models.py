"""The four assigned recsys architectures: xDeepFM, AutoInt, DIN, BST.

The JAX package's ``models/recsys/models.py`` in PyTorch.  Shared
anatomy: sparse embedding tables (see embedding.py) -> feature-interaction
op -> small MLP -> logit.  Per-model interaction:

* xDeepFM  [arXiv:1803.05170] -- CIN: layered outer-product + 1x1-conv
  compress, sum-pool per layer, plus a deep MLP branch and a linear branch.
* AutoInt  [arXiv:1810.11921] -- multi-head self-attention over the 39 field
  embeddings with residuals.
* DIN      [arXiv:1706.06978] -- target attention over the user's behaviour
  history through the (hist, target, hist-target, hist*target) MLP.
* BST      [arXiv:1905.06874] -- one transformer block over the behaviour
  sequence + target item, then a deep MLP.

``<model>_init(cfg, generator=None, device="cuda", seed=0)`` returns a
:class:`~repro_torch.models.tree_module.TreeModule` holding the
reference's parameter tree; the forward functions take it (or a plain
tree) as the reference's take their params.  Every model also exposes
``user_embedding`` (its natural user representation) so the paper's
encoded-vector search can serve as its candidate-retrieval phase
(``retrieval_cand``; see repro_torch/serve/retrieval.py).

The models compute in float32 throughout; on the card their products
need TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``) to be
the reference's arithmetic.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..common import (dense_init, div, embed_init, mlp_apply, mlp_init,
                      rms_norm, seeded, sigmoid_bce)
from ..tree_module import TreeModule, params_of
from .embedding import field_lookup, field_offsets, flat_table_init

__all__ = [
    "XDeepFMConfig", "AutoIntConfig", "DINConfig", "BSTConfig",
    "xdeepfm_init", "xdeepfm_forward", "autoint_init", "autoint_forward",
    "din_init", "din_forward", "bst_init", "bst_forward", "bce_loss",
    "xdeepfm_user_embedding", "autoint_user_embedding",
    "din_user_embedding", "bst_user_embedding", "init_for",
]


def _offsets(cfg, device) -> torch.Tensor:
    return torch.as_tensor(field_offsets(cfg.vocab_sizes), device=device)


# ============================================================== xDeepFM (CIN)
@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    cin_layers: Tuple[int, ...] = (200, 200, 200)
    mlp: Tuple[int, ...] = (400, 400)
    field_vocab: int = 100_000
    n_dense: int = 13

    @property
    def vocab_sizes(self):
        return [self.field_vocab] * self.n_sparse


def xdeepfm_init(cfg: XDeepFMConfig, generator: Optional[torch.Generator] = None,
                 device="cuda", seed: int = 0) -> TreeModule:
    g = seeded(generator, device, seed)
    m, D = cfg.n_sparse, cfg.embed_dim
    cin_ws = []
    h_prev = m
    table = flat_table_init(cfg.vocab_sizes, D, g, device)
    for h in cfg.cin_layers:
        cin_ws.append(dense_init((h_prev * m, h), g, device=device))
        h_prev = h
    return TreeModule(cfg, {
        "table": table,
        "linear": embed_init((int(np.sum(cfg.vocab_sizes)),), g, device=device),
        "cin": cin_ws,
        "mlp": mlp_init([m * D + cfg.n_dense, *cfg.mlp, 1], g, device=device),
        "cin_out": dense_init((int(np.sum(cfg.cin_layers)), 1), g, device=device),
        "bias": torch.zeros((), device=device),
    })


def _cin_layer(xs, x0, W):
    """X^k[b,h,d] = relu(sum_{i,j} W[i*m+j, h] X^{k-1}[b,i,d] X^0[b,j,d]):
    the reference's (B, H*m, D) outer product, laid out (B, D, H*m) so
    the compress is one (B*D, H*m) @ (H*m, h) product with no copy."""
    B, H, D = xs.shape
    z = xs.transpose(1, 2)[..., :, None] * x0.transpose(1, 2)[..., None, :]
    out = z.reshape(B * D, -1) @ W                       # (B*D, h)
    return F.relu(out.reshape(B, D, -1).transpose(1, 2))  # (B, h, D)


def xdeepfm_forward(params, batch: Dict, cfg: XDeepFMConfig):
    p = params_of(params)
    ids = batch["sparse_ids"]
    offs = _offsets(cfg, ids.device)
    x0 = field_lookup(p["table"], ids, offs)                         # (B, m, D)
    B, m, D = x0.shape

    xs, pooled = x0, []
    for W in p["cin"]:
        xs = _cin_layer(xs, x0, W)
        pooled.append(xs.sum(-1))                                    # (B, Hk)
    cin_feat = torch.cat(pooled, dim=-1)
    cin_logit = cin_feat @ p["cin_out"]

    deep_in = torch.cat([x0.reshape(B, m * D), batch["dense"]], dim=-1)
    deep_logit = mlp_apply(p["mlp"], deep_in, act="relu")

    lin_logit = field_lookup(p["linear"], ids, offs).sum(-1, keepdim=True)

    return (cin_logit + deep_logit + lin_logit)[:, 0] + p["bias"]


def xdeepfm_user_embedding(params, batch, cfg: XDeepFMConfig):
    p = params_of(params)
    ids = batch["sparse_ids"]
    return field_lookup(p["table"], ids, _offsets(cfg, ids.device)).mean(1)


# ================================================================== AutoInt
@dataclasses.dataclass(frozen=True)
class AutoIntConfig:
    name: str = "autoint"
    n_sparse: int = 39
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    field_vocab: int = 100_000
    n_dense: int = 13

    @property
    def vocab_sizes(self):
        return [self.field_vocab] * self.n_sparse


def autoint_init(cfg: AutoIntConfig, generator: Optional[torch.Generator] = None,
                 device="cuda", seed: int = 0) -> TreeModule:
    g = seeded(generator, device, seed)
    d_in = cfg.embed_dim
    table = flat_table_init(cfg.vocab_sizes, cfg.embed_dim, g, device)
    layers = []
    for _ in range(cfg.n_attn_layers):
        shape = (d_in, cfg.n_heads, cfg.d_attn)
        layers.append({
            "wq": dense_init(shape, g, device=device),
            "wk": dense_init(shape, g, device=device),
            "wv": dense_init(shape, g, device=device),
            "wres": dense_init((d_in, cfg.n_heads * cfg.d_attn), g, device=device),
        })
        d_in = cfg.n_heads * cfg.d_attn
    return TreeModule(cfg, {
        "table": table,
        "attn": layers,
        "out": dense_init((cfg.n_sparse * d_in + cfg.n_dense, 1), g, device=device),
        "bias": torch.zeros((), device=device),
    })


def autoint_forward(params, batch: Dict, cfg: AutoIntConfig):
    p = params_of(params)
    ids = batch["sparse_ids"]
    h = field_lookup(p["table"], ids, _offsets(cfg, ids.device))     # (B, m, D)
    for layer in p["attn"]:
        q = torch.einsum("bmd,dhk->bmhk", h, layer["wq"])
        k = torch.einsum("bmd,dhk->bmhk", h, layer["wk"])
        v = torch.einsum("bmd,dhk->bmhk", h, layer["wv"])
        s = div(torch.einsum("bmhk,bnhk->bhmn", q, k), math.sqrt(float(cfg.d_attn)))
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhmn,bnhk->bmhk", a, v)
        o = o.reshape(*h.shape[:2], -1)
        h = F.relu(o + h @ layer["wres"])
    B = h.shape[0]
    feat = torch.cat([h.reshape(B, -1), batch["dense"]], dim=-1)
    return (feat @ p["out"])[:, 0] + p["bias"]


def autoint_user_embedding(params, batch, cfg: AutoIntConfig):
    p = params_of(params)
    ids = batch["sparse_ids"]
    return field_lookup(p["table"], ids, _offsets(cfg, ids.device)).mean(1)


# ===================================================================== DIN
@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: Tuple[int, ...] = (80, 40)
    mlp: Tuple[int, ...] = (200, 80)
    item_vocab: int = 1_000_000
    n_dense: int = 13


def din_init(cfg: DINConfig, generator: Optional[torch.Generator] = None,
             device="cuda", seed: int = 0) -> TreeModule:
    g = seeded(generator, device, seed)
    D = cfg.embed_dim
    return TreeModule(cfg, {
        "items": embed_init((cfg.item_vocab, D), g, device=device),
        "attn_mlp": mlp_init([4 * D, *cfg.attn_mlp, 1], g, device=device),
        "mlp": mlp_init([2 * D + cfg.n_dense, *cfg.mlp, 1], g, device=device),
        "bias": torch.zeros((), device=device),
    })


def din_attention(params, hist, target, mask):
    """DIN local activation unit -> weighted-sum interest (B, D)."""
    p = params_of(params)
    t = target[:, None, :].expand_as(hist)
    feat = torch.cat([hist, t, hist - t, hist * t], dim=-1)         # (B, L, 4D)
    w = mlp_apply(p["attn_mlp"], feat, act="relu")[..., 0]           # (B, L)
    w = torch.where(mask > 0, w, 0.0)  # paper: no softmax; masked weights
    return (hist * w[..., None]).sum(1)


def _items(p, batch):
    hist = F.embedding(batch["hist_ids"].long(), p["items"])         # (B, L, D)
    target = F.embedding(batch["target_id"].long(), p["items"])      # (B, D)
    return hist, target


def din_forward(params, batch: Dict, cfg: DINConfig):
    p = params_of(params)
    hist, target = _items(p, batch)
    interest = din_attention(p, hist, target, batch["hist_mask"])
    feat = torch.cat([interest, target, batch["dense"]], dim=-1)
    return mlp_apply(p["mlp"], feat, act="relu")[:, 0] + p["bias"]


def din_user_embedding(params, batch, cfg: DINConfig):
    p = params_of(params)
    hist, target = _items(p, batch)
    return din_attention(p, hist, target, batch["hist_mask"])


# ===================================================================== BST
@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    mlp: Tuple[int, ...] = (1024, 512, 256)
    item_vocab: int = 1_000_000
    n_dense: int = 13

    @property
    def d_head(self):
        return self.embed_dim // self.n_heads


def bst_init(cfg: BSTConfig, generator: Optional[torch.Generator] = None,
             device="cuda", seed: int = 0) -> TreeModule:
    g = seeded(generator, device, seed)
    D = cfg.embed_dim
    items = embed_init((cfg.item_vocab, D), g, device=device)
    pos = embed_init((cfg.seq_len + 1, D), g, device=device)
    mlp = mlp_init([(cfg.seq_len + 1) * D + cfg.n_dense, *cfg.mlp, 1], g,
                   device=device)
    blocks = []
    for _ in range(cfg.n_blocks):
        qkv = (D, cfg.n_heads, cfg.d_head)
        blocks.append({
            "wq": dense_init(qkv, g, device=device),
            "wk": dense_init(qkv, g, device=device),
            "wv": dense_init(qkv, g, device=device),
            "wo": dense_init((cfg.n_heads * cfg.d_head, D), g, device=device),
            "ff1": dense_init((D, 4 * D), g, device=device),
            "ff2": dense_init((4 * D, D), g, device=device),
            "ln1": torch.zeros((D,), device=device),
            "ln2": torch.zeros((D,), device=device),
        })
    return TreeModule(cfg, {"items": items, "pos": pos, "blocks": blocks,
                            "mlp": mlp, "bias": torch.zeros((), device=device)})


def _bst_encode(params, batch, cfg: BSTConfig):
    p = params_of(params)
    hist, target = _items(p, batch)                                  # (B, L, D)
    seq = torch.cat([hist, target[:, None, :]], dim=1)               # (B, L+1, D)
    seq = seq + p["pos"][None]
    hm = batch["hist_mask"]
    mask = torch.cat([hm, torch.ones_like(hm[:, :1])], dim=1)
    for blk in p["blocks"]:
        x = rms_norm(seq, blk["ln1"])
        q = torch.einsum("bld,dhk->blhk", x, blk["wq"])
        k = torch.einsum("bld,dhk->blhk", x, blk["wk"])
        v = torch.einsum("bld,dhk->blhk", x, blk["wv"])
        s = div(torch.einsum("blhk,bmhk->bhlm", q, k), math.sqrt(float(cfg.d_head)))
        s = torch.where(mask[:, None, None, :] > 0, s, -1e30)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhlm,bmhk->blhk", a, v).reshape(*seq.shape[:2], -1)
        seq = seq + o @ blk["wo"]
        x = rms_norm(seq, blk["ln2"])
        seq = seq + F.relu(x @ blk["ff1"]) @ blk["ff2"]
    return seq, mask


def bst_forward(params, batch: Dict, cfg: BSTConfig):
    p = params_of(params)
    seq, _ = _bst_encode(p, batch, cfg)
    B = seq.shape[0]
    feat = torch.cat([seq.reshape(B, -1), batch["dense"]], dim=-1)
    return mlp_apply(p["mlp"], feat, act="relu")[:, 0] + p["bias"]


def bst_user_embedding(params, batch, cfg: BSTConfig):
    seq, mask = _bst_encode(params, batch, cfg)
    return div((seq * mask[..., None]).sum(1),
               torch.clamp(mask.sum(-1, keepdim=True), min=1e-9))


# ---------------------------------------------------------------------- loss
def bce_loss(forward_fn, params, batch, cfg):
    return sigmoid_bce(forward_fn(params, batch, cfg), batch["label"])


_INITS = {XDeepFMConfig: xdeepfm_init, AutoIntConfig: autoint_init,
          DINConfig: din_init, BSTConfig: bst_init}


def init_for(cfg):
    """The init function of ``cfg``'s model."""
    return _INITS[type(cfg)]
