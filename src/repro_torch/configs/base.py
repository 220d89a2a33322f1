"""Config layer: each family's cells for the dry run.

Every architecture exposes, per input shape, one ``Cell``: the step
function, its abstract arguments and the :class:`P` trees that place
them on the production meshes.  Arguments are ``meta`` tensors, and
models built on the ``meta`` device with no generator (nothing is
allocated); each carries the reference's dtype (tokens and ids int32),
so per-device byte counts equal the reference's.  A model argument's
spec tree is that of its ``tree()``, the reference's stacked tree.  The
dry run (``launch/dryrun.py``) traces each cell's ``fn`` once under the
op census and prices its arguments on the 16 x 16 and 2 x 16 x 16
meshes.

``LMArch`` holds an architecture's full config, its optimizer, the input
shapes it is measured at (``SHAPES``, the reference's table), the shapes
it skips, an ``accum`` override and the reduced ``smoke()`` config.
``GNNArch`` holds gin-tu's base config and resolves it per input shape
(``cfg_for``); ``RecsysArch`` holds a recsys model's config, its init,
forward and user-tower functions and its reduced ``smoke_cfg``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist.sharding import (MODEL_AXIS, P, batch_axes,
                                       generic_param_spec, lm_param_spec,
                                       opt_state_spec, tree_specs)
from repro_torch.models.gnn import gin
from repro_torch.models.recsys import models as rs
from repro_torch.models.transformer import model as lm
from repro_torch.models.transformer.model import LMConfig
from repro_torch.train.grad import make_train_step
from repro_torch.train.optimizer import (AdafactorState, AdamWConfig,
                                         AdamWState, adafactor_init,
                                         adamw_init)
from repro_torch.train.tree import as_tree, tree_map

META = torch.device("meta")

METRIC_SPECS = {"loss": P(), "grad_norm": P(), "lr_scale": P()}


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                    # train | prefill | decode | serve | retrieval
    fn: Callable
    args: Tuple
    in_specs: Tuple
    out_specs: Any               # None -> unplaced
    note: str = ""


def _sds(shape, dtype) -> torch.Tensor:
    """An abstract argument: a ``meta`` tensor of ``shape`` and ``dtype``."""
    return torch.empty(shape, dtype=dtype, device=META)


def _bspec(mesh, sds, batch_dim: int = 0) -> P:
    """Shard the batch dim over the data axes iff it divides evenly."""
    bd = batch_axes(mesh)
    n = int(np.prod([mesh.shape[a] for a in bd]))
    shape = tuple(sds.shape)
    parts = [None] * len(shape)
    if shape and shape[batch_dim] % n == 0 and shape[batch_dim] >= n:
        parts[batch_dim] = bd
    return P(*parts)


def _batch_specs(mesh, batch):
    return tree_map(lambda s: _bspec(mesh, s), batch)


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

    # ---------------------------------------------------------- abstractions
    def params_abstract(self, cfg: Optional[LMConfig] = None) -> lm.LM:
        """The model on the ``meta`` device (``cfg`` defaults to the
        arch's)."""
        return lm.LM(cfg or self.cfg, None, device=META)

    def opt_abstract(self, params_abs):
        init = adamw_init if self.optimizer == "adamw" else adafactor_init
        return init(params_abs)

    def param_specs(self, mesh, params_abs):
        return tree_specs(as_tree(params_abs), mesh, lm_param_spec)

    def opt_specs(self, mesh, params_abs):
        pspecs = self.param_specs(mesh, params_abs)
        if self.optimizer == "adamw":
            return AdamWState(step=P(), mu=pspecs, nu=pspecs)
        tree = as_tree(params_abs)
        vr = tree_map(lambda sp, pa: opt_state_spec(sp, pa.ndim, "vr")
                      if pa.ndim >= 2 else P(), pspecs, tree)
        vc = tree_map(lambda sp, pa: opt_state_spec(sp, pa.ndim, "vc")
                      if pa.ndim >= 2 else P(), pspecs, tree)
        v = tree_map(lambda sp, pa: P() if pa.ndim >= 2 else sp, pspecs, tree)
        return AdafactorState(step=P(), vr=vr, vc=vc, v=v)

    def _cache_abstract(self, cfg, batch, seq):
        return lm.init_cache(cfg, batch, seq, device=META)

    def _cache_specs(self, mesh, cfg, batch, seq, seq_sharded: bool):
        ms = mesh.shape[MODEL_AXIS]
        bd = batch_axes(mesh)
        ndata = int(np.prod([mesh.shape[a] for a in bd]))

        def kv_spec(leaf):
            # (L, B, S_c, KV, dh)
            L, B, S_c, KV, dh = leaf.shape
            model_dim = 3 if KV % ms == 0 and KV >= ms else (
                4 if dh % ms == 0 else None)
            parts: list = [None] * 5
            if model_dim is not None:
                parts[model_dim] = MODEL_AXIS
            if seq_sharded:
                if S_c % ndata == 0:
                    parts[2] = bd
            elif B % ndata == 0 and B >= ndata:
                parts[1] = bd
            return P(*parts)

        cache_abs = self._cache_abstract(cfg, batch, seq)
        return tree_map(lambda leaf: kv_spec(leaf) if leaf.ndim == 5 else P(),
                        cache_abs)

    # ----------------------------------------------------------------- cells
    def cell(self, shape_name: str, mesh) -> Optional[Cell]:
        if shape_name in self.skip_shapes:
            return None
        info = self.SHAPES[shape_name]
        cfg = self.cfg
        name = cfg.name
        seq_sharded = info.get("seq_sharded", False)
        dcfg = (dataclasses.replace(cfg, cache_update="masked")
                if seq_sharded else cfg)
        params_abs = self.params_abstract(dcfg)
        pspecs = self.param_specs(mesh, params_abs)
        int32 = torch.int32

        if info["kind"] == "train":
            opt_abs = self.opt_abstract(params_abs)
            ospecs = self.opt_specs(mesh, params_abs)
            accum = self.accum or info.get("accum", 1)
            step = make_train_step(lm.lm_loss, AdamWConfig(), accum=accum,
                                   optimizer=self.optimizer)
            batch = {
                "tokens": _sds((info["batch"], info["seq"]), int32),
                "labels": _sds((info["batch"], info["seq"]), int32),
            }
            return Cell(
                arch=name, shape=shape_name, kind="train", fn=step,
                args=(params_abs, opt_abs, batch),
                in_specs=(pspecs, ospecs, _batch_specs(mesh, batch)),
                out_specs=(pspecs, ospecs, METRIC_SPECS),
            )

        vocab_model = (MODEL_AXIS if cfg.vocab % mesh.shape[MODEL_AXIS] == 0
                       else None)
        if info["kind"] == "prefill":
            fn = functools.partial(lm.prefill, max_seq=info["seq"])
            toks = _sds((info["batch"], info["seq"]), int32)
            cache_specs = self._cache_specs(mesh, cfg, info["batch"],
                                            info["seq"], False)
            return Cell(
                arch=name, shape=shape_name, kind="prefill", fn=fn,
                args=(params_abs, toks),
                in_specs=(pspecs, _bspec(mesh, toks)),
                out_specs=(P(batch_axes(mesh), None, vocab_model),
                           cache_specs),
            )

        # decode
        cache_abs = self._cache_abstract(dcfg, info["batch"], info["seq"])
        cache_specs = self._cache_specs(mesh, dcfg, info["batch"],
                                        info["seq"], seq_sharded)
        toks = _sds((info["batch"], 1), int32)
        pos = _sds((), int32)
        logits_spec = P(batch_axes(mesh) if not seq_sharded else None, None,
                        vocab_model)
        return Cell(
            arch=name, shape=shape_name, kind="decode", fn=_lm_decode,
            args=(params_abs, cache_abs, toks, pos),
            in_specs=(pspecs, cache_specs, _bspec(mesh, toks), P()),
            out_specs=(logits_spec, cache_specs),
            note="seq-sharded masked-ring cache" if seq_sharded else "",
        )

    def smoke(self):
        return self._smoke


def _lm_decode(model, cache, tokens, cur_pos):
    """``serve_step`` at the position ``cur_pos`` holds.  ``serve_step``
    takes a Python int (a served step never synchronises); a ``meta``
    scalar holds no value, and a step's work does not depend on it (every
    slot is read, then masked), so a ``meta`` step decodes position 0."""
    pos = 0 if cur_pos.device.type == "meta" else int(cur_pos)
    return lm.serve_step(model, cache, tokens, pos)


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

    def cell(self, shape_name: str, mesh) -> Cell:
        info = self.SHAPES[shape_name]
        cfg = self.cfg_for(shape_name)
        params_abs = gin.init_params(cfg, None, device=META)
        pspecs = tree_specs(as_tree(params_abs), mesh, generic_param_spec)
        opt_abs = adamw_init(params_abs)
        ospecs = AdamWState(step=P(), mu=pspecs, nu=pspecs)
        f32, int32 = torch.float32, torch.int32

        if info["mode"] == "node":
            loss = functools.partial(gin.node_loss, cfg=cfg)
            N, E = info["nodes"], info["edges"]
            batch = {
                "x": _sds((N, info["d_in"]), f32),
                "edge_src": _sds((E,), int32),
                "edge_dst": _sds((E,), int32),
                "labels": _sds((N,), int32),
                "label_mask": _sds((N,), f32),
            }
        else:
            loss = functools.partial(gin.graph_loss, cfg=cfg)
            B, N, E = info["batch"], info["nodes"], info["edges"]
            batch = {
                "x": _sds((B, N, info["d_in"]), f32),
                "edge_src": _sds((B, E), int32),
                "edge_dst": _sds((B, E), int32),
                "node_mask": _sds((B, N), f32),
                "labels": _sds((B,), int32),
            }
        step = make_train_step(loss, AdamWConfig())
        return Cell(
            arch=self.base_cfg.name, shape=shape_name, kind="train", fn=step,
            args=(params_abs, opt_abs, batch),
            in_specs=(pspecs, ospecs, _batch_specs(mesh, batch)),
            out_specs=(pspecs, ospecs, METRIC_SPECS),
            note="nodes/edges padded to x512 (masked)",
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

    def _batch_sds(self, B: int):
        c = self.cfg
        f32, int32 = torch.float32, torch.int32
        if self.seq:
            return {
                "hist_ids": _sds((B, c.seq_len), int32),
                "hist_mask": _sds((B, c.seq_len), f32),
                "target_id": _sds((B,), int32),
                "dense": _sds((B, c.n_dense), f32),
                "label": _sds((B,), f32),
            }
        return {
            "sparse_ids": _sds((B, c.n_sparse), int32),
            "dense": _sds((B, c.n_dense), f32),
            "label": _sds((B,), f32),
        }

    def cell(self, shape_name: str, mesh) -> Cell:
        info = self.SHAPES[shape_name]
        cfg = self.cfg
        params_abs = self.init_fn(cfg, None, device=META)
        pspecs = tree_specs(as_tree(params_abs), mesh, generic_param_spec)
        name = cfg.name
        batch = self._batch_sds(info["batch"])

        if info["kind"] == "train":
            opt_abs = adamw_init(params_abs)
            ospecs = AdamWState(step=P(), mu=pspecs, nu=pspecs)
            loss = functools.partial(rs.bce_loss, self.forward_fn, cfg=cfg)
            step = make_train_step(loss, AdamWConfig())
            return Cell(
                arch=name, shape=shape_name, kind="train", fn=step,
                args=(params_abs, opt_abs, batch),
                in_specs=(pspecs, ospecs, _batch_specs(mesh, batch)),
                out_specs=(pspecs, ospecs, METRIC_SPECS),
            )

        if info["kind"] == "serve":
            fn = functools.partial(_rs_forward, fwd=self.forward_fn, cfg=cfg)
            return Cell(
                arch=name, shape=shape_name, kind="serve", fn=fn,
                args=(params_abs, batch),
                in_specs=(pspecs, _batch_specs(mesh, batch)),
                out_specs=_bspec(mesh, _sds((info["batch"],), torch.float32)),
            )

        # retrieval: the paper's two-phase search over candidate embeddings
        from repro_torch.core.encoding import RoundingEncoder

        D = cfg.embed_dim
        enc = RoundingEncoder(2)
        fn = functools.partial(_rs_retrieval, user_fn=self.user_fn, cfg=cfg,
                               encoder=enc)
        N = info["n_cand"]
        cand_vecs = _sds((N, D), torch.float32)
        cand_codes = _sds((N, D), enc.code_dtype)
        return Cell(
            arch=name, shape=shape_name, kind="retrieval", fn=fn,
            args=(params_abs, batch, cand_vecs, cand_codes),
            in_specs=(pspecs, _batch_specs(mesh, batch),
                      _bspec(mesh, cand_vecs), _bspec(mesh, cand_codes)),
            out_specs=(P(), P()),
            note="paper-integrated two-phase retrieval",
        )


@torch.no_grad()
def _rs_forward(params, batch, fwd, cfg):
    return fwd(params, batch, cfg)


@torch.no_grad()
def _rs_retrieval(params, batch, cand_vecs, cand_codes, user_fn, cfg,
                  encoder):
    from repro_torch.serve.retrieval import retrieval_step

    u = user_fn(params, batch, cfg)
    return retrieval_step(u, cand_vecs, cand_codes, encoder=encoder,
                          page=512, k=100, trim_threshold=0.05)
