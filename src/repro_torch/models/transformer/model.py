"""Decoder-only LM covering the assigned dense transformer architectures.

The JAX package's ``models/transformer/model.py`` as an ``nn.Module``.
Heterogeneity (attention pattern, MoE cadence) is a *sub-layer period*:
layer ``i`` has kind ``sub_kinds()[i % period]``.  The reference stacks
each sub-layer's leaves over ``n_super`` and scans them; here the layers
are a ``ModuleList`` in layer order, and :meth:`LM.tree` /
:meth:`LM.load_tree` read and write the reference's stacked tree (what
the optimizers, checkpoints and ``repro_torch.interop`` work on).

Param/compute dtypes: f32 master params, bf16 matmul compute (each matmul
casts its f32 weight), f32 norms, softmax and loss reductions.  Training
recomputes each super-block in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.
Serving (``prefill``, ``serve_step``) runs under ``torch.inference_mode``
and writes the KV cache in place.

MoE layers (``moe_experts > 0``) wait for their own slice (ROADMAP Queue 1
item 9, slice 14): such a config raises ``NotImplementedError``.
``seq_parallel_attn`` shards query chunks over a model axis in the
reference; on one device that is ``attention``'s math, which runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from ..common import (CDTYPE, act_fn, dense_init, div, embed_init, rms_norm,
                      softmax_xent)
from .attention import LayerKind, attention, decode_attention, rope

__all__ = ["LMConfig", "LM", "init_params", "forward", "lm_loss", "prefill",
           "serve_step", "init_cache"]

MOE_SLICE = ("MoE layers (moe_experts > 0) are not ported yet: ROADMAP "
             "Queue 1 item 9, slice 14 (moe.py, moe_local.py)")


# ---------------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_every: int = 1          # MoE on layers where (i % moe_every) == moe_every-1
    moe_shared: int = 0
    capacity_factor: float = 1.25
    # attention pattern
    attn_pattern: str = "full"  # full | swa | alt_local_global | chunked_global4
    window: int = 0
    softcap_attn: float = 0.0
    softcap_final: float = 0.0
    qkv_bias: bool = False
    tied_embeddings: bool = False
    embed_scale: bool = False   # gemma-style sqrt(d_model) embedding multiplier
    rope_theta: float = 10000.0
    act: str = "silu"
    # chunking for memory-efficient attention
    q_chunk: int = 1024
    kv_chunk: int = 1024
    # memory policy
    param_dtype: str = "float32"   # "bfloat16" for 400B-class archs
    cache_update: str = "slice"    # "masked" when the cache seq dim is sharded
    moe_token_chunk: int = 32768   # MoE dispatch-buffer bound (tokens)
    moe_dispatch: str = "global"   # "local" = shard-local dispatch (shard_map)
    # context parallelism (the reference's TP story for head counts that do
    # not divide the model axis); one device runs plain ``attention``
    seq_parallel_attn: bool = False

    def sub_kinds(self) -> List[LayerKind]:
        if self.attn_pattern == "full":
            attns = [("full", True)]
        elif self.attn_pattern == "swa":
            attns = [("swa", True)]
        elif self.attn_pattern == "alt_local_global":
            attns = [("swa", True), ("full", True)]
        elif self.attn_pattern == "chunked_global4":
            attns = [("chunked", True)] * 3 + [("full", False)]  # iRoPE: global=NoPE
        else:
            raise ValueError(self.attn_pattern)
        moe_period = self.moe_every if self.moe_experts else 1
        period = math.lcm(len(attns), moe_period)
        kinds = []
        for i in range(period):
            a, use_rope = attns[i % len(attns)]
            is_moe = bool(self.moe_experts) and (i % moe_period == moe_period - 1)
            kinds.append(LayerKind(attn=a, use_rope=use_rope, moe=is_moe))
        return kinds

    @property
    def period(self) -> int:
        return len(self.sub_kinds())

    @property
    def n_super(self) -> int:
        if self.n_layers % self.period:
            raise ValueError(f"{self.n_layers} layers, period {self.period}")
        return self.n_layers // self.period

    def cache_len(self, kind: LayerKind, max_seq: int) -> int:
        if kind.attn in ("swa", "chunked") and 0 < self.window < max_seq:
            return self.window
        return max_seq

    def param_count(self) -> int:
        """Total parameter count (for 6ND roofline math)."""
        p = self.vocab * self.d_model * (1 if self.tied_embeddings else 2)
        for kind in self.sub_kinds():
            attn = self.d_model * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
                + self.n_heads * self.d_head * self.d_model
            if kind.moe:
                ffn = self.moe_experts * 3 * self.d_model * self.d_ff \
                    + self.d_model * self.moe_experts \
                    + self.moe_shared * 3 * self.d_model * self.d_ff
            else:
                ffn = 3 * self.d_model * self.d_ff
            p += (attn + ffn + 2 * self.d_model) * self.n_super
        return p

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared experts only)."""
        if not self.moe_experts:
            return self.param_count()
        p = self.vocab * self.d_model * (1 if self.tied_embeddings else 2)
        for kind in self.sub_kinds():
            attn = self.d_model * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
                + self.n_heads * self.d_head * self.d_model
            if kind.moe:
                ffn = (self.moe_top_k + self.moe_shared) * 3 * self.d_model * self.d_ff
            else:
                ffn = 3 * self.d_model * self.d_ff
            p += (attn + ffn) * self.n_super
        return p


# ----------------------------------------------------------------- the layers
BLOCK_LEAVES = ("ln1", "ln2", "wq", "wk", "wv", "wo")
BIAS_LEAVES = ("bq", "bk", "bv")
FFN_LEAVES = ("wg", "wu", "wd")


class Block(nn.Module):
    """One sub-layer: pre-norm attention and a gated FFN, of one kind.
    Parameters carry the reference's leaf names and shapes."""

    def __init__(self, cfg: LMConfig, kind: LayerKind, generator=None,
                 device="cuda"):
        super().__init__()
        H, KV, dh, D, F = (cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                           cfg.d_model, cfg.d_ff)
        self.cfg, self.kind = cfg, kind

        def dense(shape, scale=None):
            if generator is None:
                return nn.Parameter(torch.empty(shape, device=device))
            return nn.Parameter(dense_init(shape, generator, scale=scale,
                                           device=device))

        def zeros(shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        self.ln1, self.ln2 = zeros((D,)), zeros((D,))
        self.wq = dense((D, H, dh))
        self.wk = dense((D, KV, dh))
        self.wv = dense((D, KV, dh))
        self.wo = dense((H, dh, D), scale=1.0 / math.sqrt(H * dh))
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = (zeros((H, dh)), zeros((KV, dh)),
                                         zeros((KV, dh)))
        self.ffn = nn.ParameterDict({"wg": dense((D, F)), "wu": dense((D, F)),
                                     "wd": dense((F, D))})
        self.act = act_fn(cfg.act)

    def leaves(self) -> Dict[str, Any]:
        """The reference's leaf dict of this sub-layer (unstacked)."""
        out = {k: getattr(self, k) for k in BLOCK_LEAVES}
        if self.cfg.qkv_bias:
            out.update({k: getattr(self, k) for k in BIAS_LEAVES})
        out["ffn"] = {k: self.ffn[k] for k in FFN_LEAVES}
        return out

    def qkv(self, x, positions):
        B, S, D = x.shape
        cfg = self.cfg

        def proj(w):
            return (x @ w.to(x.dtype).reshape(D, -1)).reshape(B, S, -1, cfg.d_head)

        q, k, v = proj(self.wq), proj(self.wk), proj(self.wv)
        if cfg.qkv_bias:
            q = q + self.bq.to(x.dtype)
            k = k + self.bk.to(x.dtype)
            v = v + self.bv.to(x.dtype)
        if self.kind.use_rope:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        return q, k, v

    def out_proj(self, o):
        B, S = o.shape[:2]
        return o.reshape(B, S, -1) @ self.wo.to(o.dtype).reshape(-1, self.cfg.d_model)

    def mlp(self, x):
        f = self.ffn
        y = self.act(x @ f["wg"].to(x.dtype)) * (x @ f["wu"].to(x.dtype))
        return y @ f["wd"].to(x.dtype)

    def forward(self, h, positions):
        """Training/prefill over the full sequence -> (h, (k, v))."""
        cfg = self.cfg
        x = rms_norm(h, self.ln1)
        q, k, v = self.qkv(x, positions)
        o = attention(q, k, v, kind=self.kind.attn, window=cfg.window,
                      softcap=cfg.softcap_attn, q_chunk=cfg.q_chunk,
                      kv_chunk=cfg.kv_chunk)
        h = h + self.out_proj(o)
        return h + self.mlp(rms_norm(h, self.ln2)), (k, v)


class LM(nn.Module):
    """The decoder-only LM: ``layers`` (one :class:`Block` a layer, in
    layer order), ``embed`` (V, D), ``ln_f`` and, untied, ``unembed``
    (D, V).  ``generator=None`` leaves the weights uninitialised, for
    :meth:`load_tree`."""

    def __init__(self, cfg: LMConfig, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if cfg.moe_experts:
            raise NotImplementedError(MOE_SLICE)
        self.cfg = cfg
        kinds = cfg.sub_kinds()
        self.layers = nn.ModuleList(
            Block(cfg, kinds[i % cfg.period], generator, device)
            for i in range(cfg.n_layers))
        shape = (cfg.vocab, cfg.d_model)
        self.embed = nn.Parameter(
            embed_init(shape, generator, device=device) if generator is not None
            else torch.empty(shape, device=device))
        self.ln_f = nn.Parameter(torch.zeros((cfg.d_model,), device=device))
        if not cfg.tied_embeddings:
            shape = (cfg.d_model, cfg.vocab)
            self.unembed = nn.Parameter(
                dense_init(shape, generator, device=device)
                if generator is not None else torch.empty(shape, device=device))
        if cfg.param_dtype != "float32":
            self.to(getattr(torch, cfg.param_dtype))

    # ------------------------------------------------ the reference's tree
    def tree(self, grads: bool = False) -> Dict[str, Any]:
        """The reference's parameter tree, leaves stacked over ``n_super``
        (copies; ``grads=True`` stacks the ``.grad`` tensors)."""
        get = (lambda p: p.grad) if grads else (lambda p: p.detach())
        P = self.cfg.period
        blocks = {}
        for p_i in range(P):
            subs = [layer.leaves() for layer in self.layers[p_i::P]]
            blocks[f"sub{p_i}"] = _map_stack(subs, get)
        out = {"blocks": blocks, "embed": get(self.embed), "ln_f": get(self.ln_f)}
        if not self.cfg.tied_embeddings:
            out["unembed"] = get(self.unembed)
        return out

    @torch.no_grad()
    def load_tree(self, tree: Dict[str, Any]) -> "LM":
        """Copy the reference's stacked tree into the parameters."""
        P = self.cfg.period
        for i, layer in enumerate(self.layers):
            _map_copy(layer.leaves(), tree["blocks"][f"sub{i % P}"], i // P)
        self.embed.copy_(tree["embed"])
        self.ln_f.copy_(tree["ln_f"])
        if not self.cfg.tied_embeddings:
            self.unembed.copy_(tree["unembed"])
        return self

    # ---------------------------------------------------------- the pieces
    def embed_tokens(self, tokens):
        """Gather f32 rows, then cast: the reference's cast-then-gather,
        bit for bit, without a bf16 copy of the whole table."""
        h = torch.nn.functional.embedding(tokens, self.embed).to(CDTYPE)
        if self.cfg.embed_scale:
            h = h * torch.tensor(math.sqrt(self.cfg.d_model), dtype=CDTYPE,
                                 device=h.device)
        return h

    def logits(self, h):
        h = rms_norm(h, self.ln_f)
        unembed = self.embed.t() if self.cfg.tied_embeddings else self.unembed
        logits = h @ unembed.to(h.dtype)
        cap = self.cfg.softcap_final
        if cap:
            logits = cap * torch.tanh(div(logits, cap))
        return logits

    def _super_block(self, s: int, h, positions, cache):
        P = self.cfg.period
        S = h.shape[1]
        for p_i in range(P):
            h, (k, v) = self.layers[s * P + p_i](h, positions)
            if cache is not None:
                _fill_cache(cache[f"sub{p_i}"], s, k, v, S)
        return h

    def forward(self, tokens, cache: Optional[dict] = None,
                last_only: bool = False):
        """-> (logits, aux_loss).  tokens: (B, S) int.  ``cache`` (from
        :func:`init_cache`) is filled with every layer's keys and values as
        the reference's ``collect_cache_len``; ``last_only`` unembeds the
        final position only."""
        B, S = tokens.shape
        h = self.embed_tokens(tokens)
        positions = torch.arange(S, device=tokens.device)[None, :]
        recompute = torch.is_grad_enabled() and cache is None
        for s in range(self.cfg.n_super):
            if recompute:
                h = torch.utils.checkpoint.checkpoint(
                    self._super_block, s, h, positions, None,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                h = self._super_block(s, h, positions, cache)
        if last_only:
            h = h[:, -1:]
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return self.logits(h), aux


def _map_stack(subs: list, get) -> Dict[str, Any]:
    out = {}
    for key, val in subs[0].items():
        if isinstance(val, dict):
            out[key] = _map_stack([s[key] for s in subs], get)
        else:
            out[key] = torch.stack([get(s[key]) for s in subs])
    return out


def _map_copy(leaves: dict, stacked: dict, j: int) -> None:
    for key, val in leaves.items():
        if isinstance(val, dict):
            _map_copy(val, stacked[key], j)
        else:
            val.copy_(stacked[key][j])


def _fill_cache(c: dict, s: int, k, v, S: int) -> None:
    """The reference's prefill cache: the last L positions where the cache
    is shorter than the sequence, else the sequence padded (pos -1)."""
    L = c["k"].shape[2]
    if L < S:
        c["k"][s].copy_(k[:, S - L:])
        c["v"][s].copy_(v[:, S - L:])
        c["pos"][s].copy_(torch.arange(L, device=k.device) + (S - L))
    else:
        c["k"][s, :, :S].copy_(k)
        c["v"][s, :, :S].copy_(v)
        c["pos"][s, :S].copy_(torch.arange(S, device=k.device))


# ------------------------------------------------------------------ functions
def init_params(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                device="cuda", seed: int = 0) -> LM:
    """A seeded random LM on ``device`` (``generator`` defaults to one on
    ``device`` seeded with ``seed``)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return LM(cfg, generator, device)


def forward(model: LM, tokens, collect_cache_len: int = 0,
            last_only: bool = False):
    """-> (logits, aux_loss, caches|None), as the reference's."""
    cache = None
    if collect_cache_len:
        cache = init_cache(model.cfg, tokens.shape[0], collect_cache_len,
                           device=tokens.device)
    logits, aux = model(tokens, cache=cache, last_only=last_only)
    return logits, aux, cache


def lm_loss(model: LM, batch, aux_coef: float = 0.01):
    logits, aux = model(batch["tokens"])
    mask = torch.ones(batch["labels"].shape, dtype=torch.float32,
                      device=logits.device)
    # last position predicts a rolled token; mask it out
    mask[:, -1] = 0.0
    return softmax_xent(logits, batch["labels"], mask) + aux_coef * aux


# ------------------------------------------------------------------- serving
def init_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=CDTYPE,
               device="cuda"):
    """Per sub-layer kind: k, v (n_super, B, L, KV, dh) and pos (n_super,
    L), -1 for an empty slot."""
    cache = {}
    for p_i, kind in enumerate(cfg.sub_kinds()):
        L = cfg.cache_len(kind, max_seq)
        shape = (cfg.n_super, batch, L, cfg.n_kv_heads, cfg.d_head)
        cache[f"sub{p_i}"] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((cfg.n_super, L), -1, dtype=torch.int32,
                              device=device),
        }
    return cache


@torch.inference_mode()
def prefill(model: LM, tokens, max_seq: int):
    """Prefill: forward + cache build -> (last-position logits, cache)."""
    cache = init_cache(model.cfg, tokens.shape[0], max_seq, device=tokens.device)
    logits, _ = model(tokens, cache=cache, last_only=True)
    return logits, cache


@torch.inference_mode()
def serve_step(model: LM, cache, tokens, cur_pos: int):
    """One decode step.  tokens: (B, 1); ``cur_pos`` a Python int, so a
    step does not synchronise.  -> (logits (B, 1, V), cache): the ring
    slot ``cur_pos % L`` of every layer is written in place, and the same
    cache tensors are returned."""
    cfg = model.cfg
    P = cfg.period
    B = tokens.shape[0]
    h = model.embed_tokens(tokens)
    positions = torch.full((B, 1), cur_pos, device=tokens.device)
    for i, layer in enumerate(model.layers):
        c, j = cache[f"sub{i % P}"], i // P
        q, k, v = layer.qkv(rms_norm(h, layer.ln1), positions)
        L = c["k"].shape[2]
        slot = cur_pos % L
        if cfg.cache_update == "masked":
            # the reference's select-based ring write (no dynamic index on a
            # sharded cache axis): every slot rewritten, one selected
            sel = torch.arange(L, device=h.device) == slot
            c["k"][j].copy_(torch.where(sel[None, :, None, None], k, c["k"][j]))
            c["v"][j].copy_(torch.where(sel[None, :, None, None], v, c["v"][j]))
            c["pos"][j].copy_(torch.where(sel, cur_pos, c["pos"][j]))
        else:
            c["k"][j, :, slot] = k[:, 0]
            c["v"][j, :, slot] = v[:, 0]
            c["pos"][j, slot] = cur_pos
        o = decode_attention(q, c["k"][j], c["v"][j], c["pos"][j], cur_pos,
                             kind=layer.kind.attn, window=cfg.window,
                             softcap=cfg.softcap_attn)
        h = h + layer.out_proj(o)
        h = h + layer.mlp(rms_norm(h, layer.ln2))
    return model.logits(h), cache
