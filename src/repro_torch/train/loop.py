"""Fault-tolerant training loop: resume-from-checkpoint, straggler policy.

The JAX package's ``train/loop.py`` on a model:
* all mutable state is (params, opt_state, data_state); params and
  optimizer state are checkpointed together in the reference's tree, so a
  preempted run resumes bit-exactly from the last complete step;
* per-step wall-clock is watched against the median of the last 32 steps;
  a slow step triggers ``on_straggler``;
* ``make_batch(step)`` is seedable and skippable, so a restart replays the
  exact batch sequence.
A step ends with one synchronise (where the reference blocks on the loss).
A model is trained in place: pass a fresh one to each run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .checkpoint import AsyncCheckpointer, restore_checkpoint
from .tree import as_tree, load_tree

__all__ = ["TrainLoopConfig", "run_train_loop"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 100
    log_every: int = 10
    straggler_factor: float = 5.0    # step slower than factor x rolling median
    straggler_warmup: int = 8
    resume: bool = True


def _block(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def run_train_loop(
    train_step: Callable,            # (params, opt_state, batch) -> (p, s, metrics)
    params: Any,
    opt_state: Any,
    make_batch: Callable[[int], Any],  # step index -> batch (seedable/skippable)
    cfg: TrainLoopConfig,
    on_straggler: Optional[Callable[[int, float], None]] = None,
    on_metrics: Optional[Callable[[int, Dict], None]] = None,
):
    ckpt = AsyncCheckpointer(cfg.ckpt_dir)
    start_step = 0
    if cfg.resume:
        state = {"params": as_tree(params), "opt": opt_state}
        state, step = restore_checkpoint(cfg.ckpt_dir, state)
        if step is not None:
            params = load_tree(params, state["params"])
            opt_state, start_step = state["opt"], step
        del state       # a model's restored copy: written into it, not kept
    durations: list = []
    metrics = {}
    for step in range(start_step, cfg.total_steps):
        t0 = time.perf_counter()
        batch = make_batch(step)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        _block(metrics["loss"])
        dt = time.perf_counter() - t0

        if len(durations) >= cfg.straggler_warmup:
            # median, not mean: the first (warm-up) step would otherwise
            # inflate the budget and mask real stragglers for ~32 steps
            typical = float(np.median(durations[-32:]))
            if dt > cfg.straggler_factor * typical and on_straggler is not None:
                on_straggler(step, dt / typical)
        durations.append(dt)

        if on_metrics is not None and step % cfg.log_every == 0:
            on_metrics(step, {k: float(v) for k, v in metrics.items()})
        if (step + 1) % cfg.ckpt_every == 0 or step + 1 == cfg.total_steps:
            ckpt.save(step + 1, {"params": as_tree(params), "opt": opt_state})
    ckpt.wait()
    return params, opt_state, metrics
