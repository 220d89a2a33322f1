"""Attention for the LM family: GQA + RoPE + pattern masks, memory-efficient.

The JAX package's ``models/transformer/attention.py`` in PyTorch, for the
layer kinds of the assigned archs:

* ``full``    -- causal full attention (qwen2, gemma2 global, llama4 global)
* ``swa``     -- sliding-window attention (mixtral, starcoder2, gemma2 local)
* ``chunked`` -- chunked-local attention (llama4 iRoPE local layers: tokens
  attend only within their ``window``-sized chunk)

Prefill and training use the reference's streaming softmax over KV chunks
with running (max, sum, acc), so the (S x S) score matrix is never held.
The reference maps over query chunks one at a time; here every query
chunk runs at once (one launch a KV chunk, the same arithmetic a chunk),
and a KV chunk skips the query chunks that lie wholly before it.  That
skip changes no bit: such a chunk is fully masked for those rows, whose
running max is already real (each row's own position sits in an earlier
KV chunk), so its p is exp(-1e30 - m) = 0, its correction exp(0) = 1,
and it adds exact zeros to the sums and the gradients.  A KV chunk also
skips the query chunks wholly past its reach (beyond the window of
``swa``, in a later block of ``chunked``): for those rows it comes
before any key they may see, and the first such key's correction
exp(-1e30 - m) = 0 wipes whatever it added, exactly, so skipping it
changes no bit either.

Scores are f32 from bf16 operands, as the reference's
``preferred_element_type``: q and k are upcast (exact) and multiplied in
f32; TF32 must stay off.  ``p`` is rounded to bf16 before the PV product,
which again runs in f32 on exact upcasts.  Masks are additive
``NEG_INF = -1e30``, not -inf, so a fully masked row gives no NaN.  Decode
attends one query position against the cache directly (O(S) per step).
Logit softcapping (gemma2) is ``cap * tanh(s / cap)``, applied before the
mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..common import div

__all__ = ["rope", "attention", "decode_attention", "LayerKind", "NEG_INF"]

NEG_INF = -1e30


class LayerKind(NamedTuple):
    attn: str          # full | swa | chunked
    use_rope: bool
    moe: bool


# --------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, dh), positions: broadcastable to (..., S).  Rotates
    the two halves of each head (not interleaved pairs), f32 angles."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** div(-torch.arange(0, half, dtype=torch.float32,
                                       device=x.device), half)
    ang = positions[..., None].float() * freqs               # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(div(s, cap))
    return s


def _mask_bias(qpos, kpos, kind: str, window: int) -> torch.Tensor:
    """(..., Cq, Ckv) additive bias: 0 where attending is allowed, NEG_INF
    otherwise.  qpos: (..., Cq), kpos: (Ckv,)."""
    q = qpos[..., :, None]
    k = kpos
    ok = k <= q                       # causal
    if kind == "swa" and window > 0:
        ok = ok & (k > q - window)
    elif kind == "chunked" and window > 0:
        ok = ok & (torch.div(k, window, rounding_mode="floor")
                   == torch.div(q, window, rounding_mode="floor"))
    return torch.where(ok, 0.0, NEG_INF).float()


def _repeat_kv(x: torch.Tensor, G: int) -> torch.Tensor:
    """(B, C, KV, dh) -> (B, C, KV*G, dh): query head h reads KV head
    h // G.  An expand, so the backward is a sum, not a scatter."""
    B, C, KV, dh = x.shape
    return x[:, :, :, None, :].expand(B, C, KV, G, dh).reshape(B, C, KV * G, dh)


def _last_query(k: int, kind: str, window: int, S: int) -> int:
    """One past the last query position that may attend to key ``k``."""
    if kind == "swa" and window > 0:
        return min(S, k + window)
    if kind == "chunked" and window > 0:
        return min(S, (k // window + 1) * window)
    return S


# ----------------------------------------------------- streaming chunked attn
def attention(
    q: torch.Tensor,   # (B, S, H, dh)
    k: torch.Tensor,   # (B, S, KV, dh)
    v: torch.Tensor,   # (B, S, KV, dh)
    kind: str = "full",
    window: int = 0,
    softcap: float = 0.0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    B, S, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = dh ** -0.5
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, S)
    if S % q_chunk or S % kv_chunk:
        raise ValueError(f"seq {S} is not a multiple of the chunks "
                         f"({q_chunk}, {kv_chunk})")
    nq, nkv = S // q_chunk, S // kv_chunk

    qr = q.reshape(B, nq, q_chunk, H, dh).float()
    qpos = torch.arange(S, device=q.device).reshape(nq, q_chunk)
    acc = torch.zeros((B, nq, q_chunk, H, dh), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, nq, H, q_chunk), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, nq, H, q_chunk), dtype=torch.float32, device=q.device)
    for j in range(nkv):
        lo, hi = j * kv_chunk, (j + 1) * kv_chunk
        i0 = lo // q_chunk                        # first query chunk it reaches
        i1 = -(-_last_query(hi - 1, kind, window, S) // q_chunk)
        kpos = torch.arange(lo, hi, device=q.device)
        kfull = _repeat_kv(k[:, lo:hi], G).float()  # (B, Ckv, H, dh)
        vfull = _repeat_kv(v[:, lo:hi], G)
        s = torch.einsum("bnqhd,bchd->bnhqc", qr[:, i0:i1], kfull) * scale
        s = _softcap(s, softcap)
        s = s + _mask_bias(qpos[i0:i1], kpos, kind, window)[None, :, None]
        mi, li, ai = m[:, i0:i1], l[:, i0:i1], acc[:, i0:i1]
        m_new = torch.maximum(mi, s.amax(-1))     # (B, n, H, Cq)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(mi - m_new)
        l_new = li * corr + p.sum(-1)
        pv = torch.einsum("bnhqc,bchd->bnqhd", p.to(v.dtype).float(),
                          vfull.float())
        acc_new = ai * corr.transpose(-1, -2)[..., None] + pv
        if i0 or i1 < nq:
            m = torch.cat([m[:, :i0], m_new, m[:, i1:]], 1)
            l = torch.cat([l[:, :i0], l_new, l[:, i1:]], 1)
            acc = torch.cat([acc[:, :i0], acc_new, acc[:, i1:]], 1)
        else:
            m, l, acc = m_new, l_new, acc_new
    out = acc / torch.clamp(l, min=1e-30).transpose(-1, -2)[..., None]
    return out.to(q.dtype).reshape(B, S, H, dh)


# ------------------------------------------------------------- decode (S_q=1)
def decode_attention(
    q: torch.Tensor,        # (B, 1, H, dh)
    k_cache: torch.Tensor,  # (B, S_c, KV, dh)
    v_cache: torch.Tensor,  # (B, S_c, KV, dh)
    kv_pos: torch.Tensor,   # (S_c,) int32 absolute positions, -1 = empty slot
    cur_pos: int,           # position of the query token
    kind: str = "full",
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    B, _, H, dh = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = dh ** -0.5
    qh = q[:, 0].reshape(B, KV, G, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(), k_cache.float()) * scale
    s = _softcap(s, softcap)
    ok = (kv_pos >= 0) & (kv_pos <= cur_pos)
    if kind == "swa" and window > 0:
        ok = ok & (kv_pos > cur_pos - window)
    elif kind == "chunked" and window > 0:
        ok = ok & (torch.div(kv_pos, window, rounding_mode="floor")
                   == cur_pos // window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, dh).to(q.dtype)
