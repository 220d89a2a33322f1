"""Train-step factory: microbatch gradient accumulation + optimizer update.

``make_train_step(loss_fn, cfg, accum)`` returns
``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``,
the JAX package's ``train/grad.py`` on an ``nn.Module``: each microbatch's
backward adds its f32 gradients into ``.grad`` in microbatch order (the
reference's zero + g1 + g2 + ...), the sums are divided by ``accum``,
and the optimizer updates the model's reference tree (``model.tree()``),
which is written back into the module in place.  ``opt_state`` is
replaced, as in the reference.  Nothing here synchronises with the card.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.common import div
from .optimizer import AdamWConfig, adafactor_update, adamw_update, global_norm
from .tree import tree_map

__all__ = ["make_train_step"]


def _split_batch(batch, accum: int) -> list:
    """The reference's microbatches: (B, ...) reshaped to (B/accum, accum,
    ...) and swapped, so microbatch i holds rows i, i + accum, ..."""
    def check(x):
        if x.shape[0] % accum:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                             f"accum {accum}")
    tree_map(check, batch)
    return [tree_map(lambda x: x[i::accum], batch) for i in range(accum)]


def make_train_step(
    loss_fn: Callable,            # loss_fn(model, microbatch) -> scalar
    opt_cfg: AdamWConfig = AdamWConfig(),
    accum: int = 1,
    lr_schedule: Optional[Callable] = None,
    optimizer: str = "adamw",     # adamw | adafactor
):
    update = {"adamw": adamw_update, "adafactor": adafactor_update}[optimizer]

    def train_step(model, opt_state, batch):
        micro = [batch] if accum == 1 else _split_batch(batch, accum)
        loss = None
        for mb in micro:
            l = loss_fn(model, mb)
            l.backward()
            l = l.detach().float()
            loss = l if loss is None else loss + l
        grads = model.tree(grads=True)
        for p in model.parameters():
            p.grad = None
        if accum > 1:
            loss = div(loss, accum)
            grads = tree_map(lambda g: div(g, accum), grads)

        lr_scale = lr_schedule(opt_state.step) if lr_schedule else 1.0
        new_tree, new_state = update(grads, opt_state, model.tree(), opt_cfg,
                                     lr_scale)
        model.load_tree(new_tree)
        metrics = {"loss": loss, "grad_norm": global_norm(grads),
                   "lr_scale": torch.as_tensor(lr_scale, dtype=torch.float32,
                                               device=loss.device)}
        return model, new_state, metrics

    return train_step
