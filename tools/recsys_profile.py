#!/usr/bin/env python3
"""Where the recsys models' and GIN's time goes on the card, at
chip_smoke.py phase M's shapes: training steps and a bulk serving call
under torch.profiler.

    python3 tools/recsys_profile.py      # needs a CUDA card

Regions: ``<model>_train``, one ``make_train_step`` step (forward,
backward, AdamW over the whole tree) of each recsys model at its
published config and train_batch's 65,536 rows (at M1's accumulation,
``chip_smoke.M_ACCUM``); ``xdeepfm_serve_chunk``, one chunk of M2's
rows (``chip_smoke.M_BULK_CHUNK``) of xDeepFM's serve_bulk under
no_grad; ``gin_ogb_products_train``, one gin-tu step
on an ogbn-products-sized random graph (2,449,029 nodes x 100
features, 61,859,140 edges).  Each is run once to warm up, once timed
(profiler off), once profiled (``tools/lm_profile.py``'s ``profile``),
and printed as one JSON line: host seconds, the kernels' summed device
time, the card's idle share, device time by class and the top kernels.
The classes add ``embedding`` (lookups, bags and their sorted
backwards) and ``sort`` to lm_profile's.  Float32 with TF32 off, as in
phase M; then the card's name and power limit.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import lm_profile  # noqa: E402
from chip_smoke import M_ACCUM, M_BULK_CHUNK  # noqa: E402


def kernel_class(name: str) -> str:
    n = name.lower()
    if "embedding" in n or "segment" in n or "bag" in n:
        return "embedding"
    if "sort" in n or "radix" in n:
        return "sort"
    return lm_profile.kernel_class(name)


def cuda(b) -> dict:
    return {k: torch.from_numpy(v).cuda() for k, v in b.items()}


def profile_recsys(arch_id: str, accum: int) -> None:
    from repro_torch.configs import get_arch
    from repro_torch.data import recsys_batch
    from repro_torch.models.recsys.models import bce_loss
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    arch = get_arch(arch_id)
    cfg = arch.cfg
    rng = np.random.default_rng(0)
    if arch.seq:
        b = recsys_batch(rng, 65_536, 1, [cfg.item_vocab], seq_len=cfg.seq_len)
    else:
        b = recsys_batch(rng, 65_536, cfg.n_sparse, cfg.vocab_sizes)
    batch = cuda(b)
    state = {"m": arch.init_fn(cfg, device="cuda", seed=0)}
    state["o"] = adamw_init(state["m"])
    step = make_train_step(lambda m, bb: bce_loss(arch.forward_fn, m, bb, cfg),
                           AdamWConfig(), accum=accum)

    def train_step():
        state["m"], state["o"], _ = step(state["m"], state["o"], batch)

    print(json.dumps(lm_profile.profile(f"{arch_id}_train", train_step,
                                         kernel_class)),
          flush=True)
    if arch_id in M_BULK_CHUNK:
        chunk = {k: v[:M_BULK_CHUNK[arch_id]] for k, v in batch.items()}

        @torch.no_grad()
        def serve():
            arch.forward_fn(state["m"], chunk, cfg)

        print(json.dumps(lm_profile.profile(f"{arch_id}_serve_chunk", serve,
                                            kernel_class)),
              flush=True)


def profile_gin() -> None:
    from repro_torch.configs import get_arch
    from repro_torch.data import random_graph
    from repro_torch.models.gnn import gin
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    cfg = get_arch("gin-tu").cfg_for("ogb_products")
    g = cuda(random_graph(np.random.default_rng(0), 2_449_029, 61_859_140,
                          cfg.d_in, cfg.n_classes))
    state = {"m": gin.init_params(cfg, device="cuda", seed=0)}
    state["o"] = adamw_init(state["m"])
    step = make_train_step(lambda m, b: gin.node_loss(m, b, cfg), AdamWConfig())

    def gin_step():
        state["m"], state["o"], _ = step(state["m"], state["o"], g)

    print(json.dumps(lm_profile.profile("gin_ogb_products_train", gin_step,
                                         kernel_class)),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("recsys_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE.parent / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch_id in ("xdeepfm", "autoint", "din", "bst"):
        profile_recsys(arch_id, M_ACCUM.get(arch_id, 1))
        torch.cuda.empty_cache()
    profile_gin()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
