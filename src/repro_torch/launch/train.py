"""Training launcher: --arch <id> resolves the registry config and runs the
fault-tolerant loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --smoke --steps 20 --device cpu

``--smoke`` trains the arch's reduced config (data -> step -> checkpoint
-> resume) on ``--device`` (``cuda`` unless asked otherwise) with the
arch's optimizer (Adafactor for llama4, AdamW for the rest): an LM's
``smoke()`` config on token streams (the two MoE LMs' included), gin-tu's ``full_graph_sm`` config
cut to 16 features and 4 classes on random 128-node graphs, a recsys
model's ``smoke_cfg`` on click batches.  The JAX package's launcher
refuses a run without it, and so does this one.
Checkpoints go to ``<--ckpt-dir>_<arch>``; a second run on the same
directory resumes from its newest complete step.  The arch ids are the
ten assigned ones (``repro_torch.configs.ARCH_IDS``; ``vectordb-wiki``
trains nothing).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import GNNArch, LMArch, RecsysArch
from repro_torch.data import lm_batch, random_graph, recsys_batch
from repro_torch.train import (AdamWConfig, TrainLoopConfig, adafactor_init,
                               adamw_init, cosine_schedule, latest_step,
                               make_train_step, run_train_loop)

SMOKE_SEQ = 32


def _to(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _smoke_setup(arch, batch_size: int, device):
    if isinstance(arch, LMArch):
        from repro_torch.models.transformer import model as lm

        cfg = arch.smoke()
        params = lm.init_params(cfg, device=device, seed=0)
        loss = lambda p, b: lm.lm_loss(p, b)

        def make_batch(i):
            r = np.random.default_rng(i)
            return _to(lm_batch(r, batch_size, SMOKE_SEQ, cfg.vocab), device)

    elif isinstance(arch, GNNArch):
        import dataclasses

        from repro_torch.models.gnn import gin

        cfg = dataclasses.replace(arch.cfg_for("full_graph_sm"), d_in=16,
                                  n_classes=4)
        params = gin.init_params(cfg, device=device, seed=0)
        loss = lambda p, b: gin.node_loss(p, b, cfg)

        def make_batch(i):
            return _to(random_graph(np.random.default_rng(i), 128, 512, 16, 4),
                       device)

    else:
        assert isinstance(arch, RecsysArch)
        from repro_torch.models.recsys.models import bce_loss

        cfg = arch.smoke_cfg
        params = arch.init_fn(cfg, device=device, seed=0)
        loss = lambda p, b: bce_loss(arch.forward_fn, p, b, cfg)

        def make_batch(i):
            r = np.random.default_rng(i)
            if arch.seq:
                b = recsys_batch(r, batch_size, 1, [cfg.item_vocab],
                                 seq_len=cfg.seq_len)
            else:
                b = recsys_batch(r, batch_size, cfg.n_sparse, cfg.vocab_sizes)
            return _to(b, device)

    return params, loss, make_batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="artifacts/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (the only mode, as the reference's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if not args.smoke:
        raise SystemExit(
            "full-scale training runs through chip_smoke.py's phases L (the "
            "dense LM), M (recsys and GIN) and N (the MoE LMs); use --smoke "
            "here")

    ckpt_dir = f"{args.ckpt_dir}_{args.arch}"
    params, loss, make_batch = _smoke_setup(arch, args.batch_size, args.device)
    optimizer = getattr(arch, "optimizer", "adamw")
    opt = (adamw_init if optimizer == "adamw" else adafactor_init)(params)
    step = make_train_step(
        loss, AdamWConfig(lr=args.lr), optimizer=optimizer,
        lr_schedule=cosine_schedule(warmup=max(args.steps // 10, 1),
                                    total=args.steps),
        donate=True)    # the loop never reuses a step's state
    start = latest_step(ckpt_dir)
    if start is not None:
        print(f"resuming at step {start} from {ckpt_dir}")
    run_train_loop(
        step, params, opt, make_batch,
        TrainLoopConfig(total_steps=args.steps, ckpt_dir=ckpt_dir,
                        ckpt_every=args.ckpt_every, log_every=10),
        on_metrics=lambda s, m: print(f"step {s:5d} loss {m['loss']:.4f} "
                                      f"gnorm {m['grad_norm']:.2f}"),
        on_straggler=lambda s, r: print(f"!! straggler at step {s}: {r:.1f}x"),
    )
    print("done")


if __name__ == "__main__":
    main()
