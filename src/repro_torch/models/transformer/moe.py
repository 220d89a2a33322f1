"""Mixture-of-Experts FFN with sort-based dispatch.

The JAX package's ``models/transformer/moe.py`` in PyTorch.  Routing is a
top-k softmax renormalised over the chosen experts (Mixtral; llama4's
top-1 is k = 1), capacity per expert ``ceil(T*k/E * capacity_factor)``;
overflow (token, choice) pairs are dropped (combine weight zero), empty
slots compute on zeros.  A Switch load-balancing loss from each token's
first choice is returned for the trainer.

Order and dtypes are the reference's:

* router logits in f32 from ``x.float() @ router.float()``, TF32 off on
  the card (the product decides routing); softmax; top-k by a stable
  descending sort, so equal probabilities pick the lower expert first, as
  ``jax.lax.top_k``; gates renormalised by ``max(sum, 1e-9)``;
* the (token, choice) pairs sorted stably by expert (``argsort(stable=
  True)``, as ``jnp.argsort``), so within an expert the first ``C`` in
  (token, choice) order keep their slots;
* the dispatch buffer (E, C, D) in ``x``'s dtype; the three expert
  products take operands in ``x``'s dtype and give **f32 results**
  (``preferred_element_type=f32``); the combine in f32, cast to ``x``'s
  dtype; then the shared expert in ``x``'s dtype.

*The f32-result products* (:func:`expert_matmul`): where ``x`` is bf16,
the operands are rounded to bf16 and multiplied as f32 tensors holding
those values, with TF32 enabled on the card around these products only,
forward and backward.  TF32 holds every bf16 value exactly, so each
product is exact and sums in f32, on the CPU (IEEE f32) and the card
alike.  The backward follows JAX's transpose: the f32 cotangent times
the other bf16 operand, f32 result, rounded to the operand's dtype (on
the card the cotangent enters the TF32 product with its low 13 mantissa
bits dropped).  Weights enter in their own dtype and are rounded inside,
so the f32 master weights are not copied for the backward.  With f32
``x`` the products are plain f32 (TF32 off).

*No atomics*: the buffer is one gather of each slot's token row
(``F.embedding``, whose backward sorts its indices), the combine one
gather of each (token, choice) pair's slot; the reference's scatter into
the buffer and its unsort (``.at[order].set``) are written as those
gathers.  The only sorts are of integers; nothing adds by atomics, so a
step is bit-equal run to run and under ``torch.use_deterministic_
algorithms``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..common import act_fn, dense_init, div

__all__ = ["moe_ffn", "moe_init", "expert_matmul", "route", "gate_values",
           "dispatch_plan"]


def moe_init(d_model: int, d_ff: int, n_experts: int, n_shared: int = 0,
             generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device="cuda") -> Dict[str, object]:
    """The reference's leaves: ``router`` (D, E), ``wg`` / ``wu`` (E, D, F),
    ``wd`` (E, F, D) and, with ``n_shared``, ``shared`` {``wg``, ``wu``:
    (D, n_shared*F), ``wd``: (n_shared*F, D)}.  Each leaf is drawn in f32
    and cast to ``dtype`` (the reference casts the whole tree); without a
    ``generator`` the leaves are left uninitialised."""
    def dense(shape):
        if generator is None:
            return torch.empty(shape, dtype=dtype, device=device)
        return dense_init(shape, generator, device=device).to(dtype)

    p = {"router": dense((d_model, n_experts)),
         "wg": dense((n_experts, d_model, d_ff)),
         "wu": dense((n_experts, d_model, d_ff)),
         "wd": dense((n_experts, d_ff, d_model))}
    if n_shared:
        p["shared"] = {"wg": dense((d_model, n_shared * d_ff)),
                       "wu": dense((d_model, n_shared * d_ff)),
                       "wd": dense((n_shared * d_ff, d_model))}
    return p


@contextlib.contextmanager
def _tf32(on: bool, cuda: bool):
    """cuBLAS's TF32 switch set to ``on`` inside (on the card only)."""
    if not cuda:
        yield
        return
    m = torch.backends.cuda.matmul
    was = m.allow_tf32
    m.allow_tf32 = on
    try:
        yield
    finally:
        m.allow_tf32 = was


def _bf16(t):
    """``t`` rounded to bf16, held in f32."""
    return t.to(torch.bfloat16).float()


class _Bf16Product(torch.autograd.Function):
    """(E, M, K) @ (E, K, N) -> f32, operands rounded to bf16 (see the
    module doc); one product an expert, so the f32 copies held at a time
    are one expert's."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        out = torch.empty((a.shape[0], a.shape[1], b.shape[2]),
                          dtype=torch.float32, device=a.device)
        with _tf32(True, a.is_cuda):
            for e in range(a.shape[0]):
                torch.mm(_bf16(a[e]), _bf16(b[e]), out=out[e])
        return out

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = torch.empty_like(a) if ctx.needs_input_grad[0] else None
        gb = torch.empty_like(b) if ctx.needs_input_grad[1] else None
        with _tf32(True, g.is_cuda):
            for e in range(a.shape[0]):
                if ga is not None:
                    ga[e] = _bf16(g[e] @ _bf16(b[e]).t())
                if gb is not None:
                    gb[e] = _bf16(_bf16(a[e]).t() @ g[e])
        return ga, gb


def expert_matmul(a: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``einsum("e..,e..->e..", a.astype(dtype), w.astype(dtype),
    preferred_element_type=f32)`` as one batched product (E, M, K) @
    (E, K, N) -> f32."""
    if dtype == torch.bfloat16:
        return _Bf16Product.apply(a, w)
    with _tf32(False, a.is_cuda):
        return torch.bmm(a.to(dtype).float(), w.to(dtype).float())


def route(p, x: torch.Tensor, top_k: int):
    """-> (probs (T, E) f32, idx (T, k) int64, gates (T, k) f32): the
    reference's router (see the module doc)."""
    with _tf32(False, x.is_cuda):
        logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :top_k]
    return probs, idx, gate_values(probs, idx)


def gate_values(probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The chosen experts' probabilities, renormalised -> (T, k) f32."""
    E = probs.shape[1]
    # each row of the one-hot picks one probability, so this sum is the
    # gathered value exactly, and its backward adds nothing by atomics
    onehot = (idx[..., None] == torch.arange(E, device=probs.device)).float()
    gates = (probs[:, None, :] * onehot).sum(-1)
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)


def dispatch_plan(idx: torch.Tensor, E: int, C: int):
    """The sort-based dispatch of the (token, choice) pairs ``idx`` (T, k):
    -> (slot_tok (E, C) token of each slot, slot_used (E, C) bool,
    pair_slot (T*k,) each pair's slot, clamped to E*C - 1 where dropped,
    pair_kept (T*k,) bool).  Pairs are sorted stably by expert; within an
    expert the first ``C`` keep slots e*C + rank."""
    T, k = idx.shape
    dev = idx.device
    e_flat = idx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    experts = torch.arange(E, device=dev)
    start = torch.searchsorted(e_sorted, experts)
    count = torch.searchsorted(e_sorted, experts, right=True) - start
    r = torch.arange(C, device=dev)
    pos = torch.clamp(start[:, None] + r, max=T * k - 1)
    slot_tok = torch.div(order[pos], k, rounding_mode="floor")
    slot_used = r < count[:, None]
    inv = torch.argsort(order)                      # pair -> sorted position
    rank = inv - start[e_flat]
    pair_kept = rank < C
    pair_slot = torch.where(pair_kept, e_flat * C + rank, E * C - 1)
    return slot_tok, slot_used, pair_slot, pair_kept


def _moe_ffn_chunk(p, x: torch.Tensor, top_k: int, capacity_factor: float,
                   act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    T, D = x.shape
    E = p["router"].shape[1]
    f = act_fn(act)
    probs, idx, gates = route(p, x, top_k)

    # Switch aux loss: E * sum_e fraction_routed_e * mean_prob_e
    me = div(probs.sum(0), T)
    first = (idx[:, :1] == torch.arange(E, device=x.device)).float()
    assign = div(first.sum(0), T)
    aux = E * torch.sum(assign * me)

    # ---- sort-based dispatch --------------------------------------------
    C = max(1, math.ceil(T * top_k / E * capacity_factor))
    slot_tok, slot_used, pair_slot, pair_kept = dispatch_plan(idx, E, C)
    buf = torch.where(slot_used[..., None], F.embedding(slot_tok, x),
                      torch.zeros((), dtype=x.dtype, device=x.device))

    # ---- expert FFNs (batched over E) -----------------------------------
    h = f(expert_matmul(buf, p["wg"], x.dtype)) * expert_matmul(
        buf, p["wu"], x.dtype)
    out_buf = expert_matmul(h.to(x.dtype), p["wd"], x.dtype)   # (E, C, D)

    # ---- combine ---------------------------------------------------------
    y_pair = torch.where(pair_kept[:, None],
                         F.embedding(pair_slot, out_buf.reshape(E * C, D)),
                         torch.zeros((), device=x.device))
    y = (y_pair * gates.reshape(-1, 1)).reshape(T, top_k, D).sum(1).to(x.dtype)

    if "shared" in p:
        sp = p["shared"]
        sh = f(x @ sp["wg"].to(x.dtype)) * (x @ sp["wu"].to(x.dtype))
        y = y + (sh @ sp["wd"].to(x.dtype)).to(x.dtype)
    return y, aux


def moe_ffn(p, x: torch.Tensor, top_k: int, capacity_factor: float = 1.25,
            act: str = "silu", token_chunk: int = 32768
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (y (T, D), aux_loss scalar f32).  ``x`` (T, D) token-major.

    Where ``T`` is a multiple of ``token_chunk`` above it, the tokens run
    in ``T // token_chunk`` chunks of their own capacity, in order, and
    aux is the mean of theirs (the reference's scan): the dispatch
    buffers scale with the chunk, not with the batch."""
    T = x.shape[0]
    if T > token_chunk and T % token_chunk == 0:
        nb = T // token_chunk
        ys, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
        for xc in x.split(token_chunk):
            y, a = _moe_ffn_chunk(p, xc, top_k, capacity_factor, act)
            ys.append(y)
            aux = aux + a
        return torch.cat(ys), div(aux, nb)
    return _moe_ffn_chunk(p, x, top_k, capacity_factor, act)
