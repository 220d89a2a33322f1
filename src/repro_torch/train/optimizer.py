"""AdamW with global-norm clipping, Adafactor, cosine schedule: the JAX
package's ``train/optimizer.py`` formulas on trees of tensors.

``torch.optim.AdamW`` (and its foreach and fused paths) orders the
arithmetic differently and does not clip, so the reference's formulas are
written out leaf by leaf.  Updates are functional: they return new trees
(a model's tree is ``model.tree()``, stacked as the reference's, so
Adafactor factors and clips the same leaves).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..models.common import div
from .tree import as_tree, tree_leaves, tree_map

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "AdafactorState", "adafactor_init", "adafactor_update",
           "cosine_schedule", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def _step0(tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(tree)[0].device)


def adamw_init(params) -> AdamWState:
    tree = as_tree(params)
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(step=_step0(tree), mu=tree_map(zeros, tree),
                      nu=tree_map(zeros, tree))


def global_norm(tree) -> torch.Tensor:
    """A Python sum over the leaves in the reference's flatten order."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves))


def _clip_scale(gn, clip_norm):
    return torch.clamp(div(clip_norm, torch.clamp(gn, min=1e-9)), max=1.0)


def adamw_update(
    grads,
    state: AdamWState,
    params,
    cfg: AdamWConfig,
    lr_scale: torch.Tensor | float = 1.0,
) -> Tuple[Any, AdamWState]:
    step = state.step + 1
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.clip_norm)
    grads = tree_map(lambda g: g.float() * scale, grads)

    mu = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g, state.nu, grads)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    lr = cfg.lr * lr_scale

    def upd(p, m, v):
        mhat = m / bc1
        vhat = v / bc2
        return (p.float()
                - lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p)
                ).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, AdamWState(step=step, mu=mu, nu=nu)


# --------------------------------------------------------------- Adafactor
# Factored second moments (Shazeer & Stern, arXiv:1804.04235), no momentum:
# the T5/PaLM memory recipe, the reference's optimizer for llama4.
class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any    # row second moment: shape[:-1]   (ndim>=2 leaves)
    vc: Any    # col second moment: shape[:-2] + (shape[-1],)
    v: Any     # full second moment for 0/1-D leaves


def _factored(p) -> bool:
    return p.ndim >= 2


def adafactor_init(params) -> AdafactorState:
    tree = as_tree(params)
    f32 = torch.float32
    zr = lambda p: (torch.zeros(p.shape[:-1], dtype=f32, device=p.device)
                    if _factored(p) else torch.zeros((), dtype=f32, device=p.device))
    zc = lambda p: (torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=f32,
                                device=p.device)
                    if _factored(p) else torch.zeros((), dtype=f32, device=p.device))
    zv = lambda p: (torch.zeros((), dtype=f32, device=p.device) if _factored(p)
                    else torch.zeros_like(p, dtype=f32))
    return AdafactorState(step=_step0(tree), vr=tree_map(zr, tree),
                          vc=tree_map(zc, tree), v=tree_map(zv, tree))


def adafactor_update(
    grads, state: AdafactorState, params, cfg: AdamWConfig,
    lr_scale: torch.Tensor | float = 1.0,
) -> Tuple[Any, AdafactorState]:
    step = state.step + 1
    t = step.float()
    beta2 = 1.0 - t ** -0.8                    # Adafactor's schedule
    gn = global_norm(grads)
    clip = _clip_scale(gn, cfg.clip_norm)
    lr = cfg.lr * lr_scale

    def upd(p, g, vr, vc, v):
        g = g.float() * clip
        g2 = g * g + 1e-30
        if _factored(p):
            vr_n = beta2 * vr + (1 - beta2) * g2.mean(-1)
            vc_n = beta2 * vc + (1 - beta2) * g2.mean(-2)
            denom = (vr_n[..., None] * vc_n[..., None, :]
                     / torch.clamp(vr_n.mean(-1)[..., None, None], min=1e-30))
            u = g * torch.rsqrt(denom + 1e-30)
            v_n = v
        else:
            v_n = beta2 * v + (1 - beta2) * g2
            u = g * torch.rsqrt(v_n + 1e-30)
            vr_n, vc_n = vr, vc
        # update clipping (RMS(u) <= 1)
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms_u, min=1.0)
        new_p = (p.float() - lr * (u + cfg.weight_decay * p)).to(p.dtype)
        return new_p, vr_n, vc_n, v_n

    out = tree_map(upd, params, grads, state.vr, state.vc, state.v)
    # ``out`` holds a 4-tuple at each of ``params``' leaves
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)
    return pick(0), AdafactorState(step=step, vr=pick(1), vc=pick(2), v=pick(3))


def cosine_schedule(warmup: int, total: int, floor: float = 0.1) -> Callable:
    def fn(step):
        step = step.float()
        warm = torch.clamp(div(step, max(warmup, 1)), max=1.0)
        prog = torch.clamp(div(step - warmup, max(total - warmup, 1)), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return warm * cos
    return fn
