"""AdamW with global-norm clipping, Adafactor, cosine schedule: the JAX
package's ``train/optimizer.py`` formulas on trees of tensors.

``torch.optim.AdamW`` (and its foreach and fused paths) orders the
arithmetic differently and does not clip, so the reference's formulas are
written out leaf by leaf.  Updates are functional: they return new trees
(a model's tree is ``model.tree()``, stacked as the reference's, so
Adafactor factors and clips the same leaves).  With ``donate=True`` (JAX's
``donate_argnums``) each leaf's new parameter and state are written into
the given ones as the leaf is done, and those trees are returned: the
same bits, without a second copy of the parameters and the state.
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


def _write(p, new) -> torch.Tensor:
    """``new`` (f32; ``p`` itself where ``p`` is f32) into ``p``, rounded
    to its dtype."""
    if new is not p:
        p.copy_(new)
    return p


def adamw_update(
    grads,
    state: AdamWState,
    params,
    cfg: AdamWConfig,
    lr_scale: torch.Tensor | float = 1.0,
    donate: bool = False,
) -> Tuple[Any, AdamWState]:
    step = state.step + 1
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.clip_norm)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    lr = cfg.lr * lr_scale

    # the reference's formulas, each op in place on the leaf's own copies
    # (its given tensors where donated): the same roundings in the same
    # order, a few leaf-sized temporaries at a time
    def upd(p, g, m, v):
        if not donate:
            p, m, v = p.clone(), m.clone(), v.clone()
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)            # b1 m + (1 - b1) g
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)        # b2 v + (1 - b2) g g
        del g
        u = (v / bc2).sqrt_().add_(cfg.eps)              # sqrt(vhat) + eps
        u = (m / bc1).div_(u)                            # mhat / (...)
        u.add_(cfg.weight_decay * p).mul_(lr)            # lr (... + wd p)
        return _write(p, p.float().sub_(u)), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu)
    # ``out`` holds a 3-tuple at each of ``params``' leaves
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)
    return pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2))


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
    lr_scale: torch.Tensor | float = 1.0, donate: bool = False,
) -> Tuple[Any, AdafactorState]:
    step = state.step + 1
    t = step.float()
    beta2 = 1.0 - t ** -0.8                    # Adafactor's schedule
    gn = global_norm(grads)
    clip = _clip_scale(gn, cfg.clip_norm)
    lr = cfg.lr * lr_scale

    def upd(p, g, vr, vc, v):        # in place, as adamw_update's
        if not donate:
            p, vr, vc, v = p.clone(), vr.clone(), vc.clone(), v.clone()
        g = g.float() * clip
        g2 = (g * g).add_(1e-30)
        if _factored(p):
            vr.mul_(beta2).add_((1 - beta2) * g2.mean(-1))
            vc.mul_(beta2).add_((1 - beta2) * g2.mean(-2))
            del g2
            denom = vr[..., None] * vc[..., None, :]
            denom.div_(torch.clamp(vr.mean(-1)[..., None, None], min=1e-30))
            u = g.mul_(denom.add_(1e-30).rsqrt_())      # g rsqrt(denom + eps)
            del denom
        else:
            v.mul_(beta2).add_((1 - beta2) * g2)
            del g2
            u = g.mul_(torch.rsqrt(v + 1e-30))
        # update clipping (RMS(u) <= 1)
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
        u.div_(torch.clamp(rms_u, min=1.0))
        u.add_(cfg.weight_decay * p).mul_(lr)            # lr (u + wd p)
        return _write(p, p.float().sub_(u)), vr, vc, v

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
