"""Shard-local MoE dispatch: GShard's "local group" semantics.

The JAX package's ``models/transformer/moe_local.py`` runs the dispatch
under ``shard_map``: each data shard sorts and buckets only its own
tokens into a capacity buffer of its own, with the parameters and tokens
in f32, and the shards' aux values are averaged.  Without a mesh it falls
back to the global path.

One device holds no mesh, so the groups are explicit here:
``groups=1`` is the reference's fallback, its ``_moe_ffn_chunk`` bit for
bit; ``groups=G`` is what the reference computes under a mesh of G data
shards: ``x`` split into G contiguous row blocks (as ``P(data, None)``
shards it), each block through ``_moe_ffn_chunk`` with the parameters
and the block in f32 and a capacity of its own, ``y`` cast back to
``x``'s dtype, aux the mean of the G values.  Capacity is per group, so
overflow drops tokens per group rather than globally.
"""

from __future__ import annotations

import torch

from ..common import div
from .moe import _moe_ffn_chunk

__all__ = ["moe_ffn_local"]


def _f32(p):
    return {k: _f32(v) if isinstance(v, dict) else v.float()
            for k, v in p.items()}


def moe_ffn_local(p, x: torch.Tensor, top_k: int, capacity_factor: float = 1.25,
                  act: str = "silu", token_chunk: int = 0, groups: int = 1):
    """Drop-in for ``moe_ffn`` with group-local dispatch -> (y, aux).
    ``token_chunk`` is taken and unused, as in the reference."""
    if groups == 1:
        return _moe_ffn_chunk(p, x, top_k, capacity_factor, act)
    if x.shape[0] % groups:
        raise ValueError(f"{x.shape[0]} tokens over {groups} groups")
    pw = _f32(p)
    ys, auxes = [], []
    for xb in x.chunk(groups):
        y, a = _moe_ffn_chunk(pw, xb.float(), top_k, capacity_factor, act)
        ys.append(y.to(x.dtype))
        auxes.append(a)
    return torch.cat(ys), div(torch.stack(auxes).sum(), groups)
