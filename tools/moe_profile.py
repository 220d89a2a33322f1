#!/usr/bin/env python3
"""Memory and time of the two MoE LMs' training cuts on the card, at
chip_smoke.py phase N's shapes.

    python3 tools/moe_profile.py          # needs a CUDA card

For mixtral-8x22b (1 of its 56 layers, f32 AdamW) and llama4-maverick
(one super-block with 16 of its 128 experts, bf16 parameters, Adafactor):
one donated training step at global batch 16 x 4,096 for each accum in
{4, 8, 16}, from a fresh seeded model: peak device memory and seconds,
or ``"oom"`` where the step does not fit (which picks N1's accum, the
smallest under about 75 GB).  Then one training microbatch (1 x 4,096
tokens: ``lm_loss`` forward and backward, each super-block recomputed)
of each cut under torch.profiler, its device time by kernel class (TF32
GEMM: the expert products; bf16 GEMM; f32 GEMM: attention and the
router; elementwise; reductions; the rest), as ``tools/lm_profile.py``
does.  Prints one JSON line a measurement, then the card's name and
power limit.  bf16 products accumulate in f32; TF32 is off but around
the expert products, as in phase N.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

# as chip_smoke.py's phase N: grow segments rather than strand freed blocks
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
CUTS = {"mixtral-8x22b": dict(n_layers=1),
        "llama4-maverick-400b-a17b": dict(n_layers=4, moe_experts=16)}
BATCH, SEQ = 16, 4_096


def kernel_class(name: str) -> str:
    """``lm_profile.kernel_class``, with TF32 products apart."""
    import lm_profile

    if "tf32" in name.lower():
        return "gemm_tf32"
    return lm_profile.kernel_class(name)


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE.parent / "src"))
    sys.path.insert(0, str(HERE))
    import lm_profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models.transformer import model as lm
    from repro_torch.train import (AdamWConfig, adafactor_init, adamw_init,
                                   make_train_step)

    def batch(cfg, seed, b):
        x = lm_batch(np.random.default_rng(seed), b, SEQ, cfg.vocab)
        return {k: torch.from_numpy(v).cuda() for k, v in x.items()}

    for arch_id, cut in CUTS.items():
        arch = get_arch(arch_id)
        cfg = dataclasses.replace(arch.cfg, **cut)
        init = adamw_init if arch.optimizer == "adamw" else adafactor_init
        for accum in (4, 8, 16):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            row = {"arch": arch_id, "params": cfg.param_count(),
                   "accum": accum, "tokens": BATCH * SEQ}
            try:
                model = lm.init_params(cfg, device="cuda", seed=0)
                opt = init(model)
                step = make_train_step(lambda m, b: lm.lm_loss(m, b),
                                       AdamWConfig(), accum=accum,
                                       optimizer=arch.optimizer, donate=True)
                b = batch(cfg, 0, BATCH)
                torch.cuda.synchronize()
                t = time.monotonic()
                step(model, opt, b)
                torch.cuda.synchronize()
                row.update(step_s=time.monotonic() - t,
                           peak_bytes=torch.cuda.max_memory_allocated())
            except torch.cuda.OutOfMemoryError:
                row.update(oom=True, peak_bytes=torch.cuda.max_memory_allocated())
            model = opt = step = b = None
            print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
        model = lm.init_params(cfg, device="cuda", seed=0)
        micro = batch(cfg, 1, 1)

        def train_micro():
            lm.lm_loss(model, micro).backward()
            model.zero_grad(set_to_none=True)

        out = lm_profile.profile(f"train {arch_id}", train_micro, kernel_class)
        print(json.dumps(out), flush=True)
        model = None
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
