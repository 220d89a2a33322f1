#!/usr/bin/env python3
"""Where qwen2-0.5b's time goes on the card, at chip_smoke.py phase L's
shapes: one training microbatch and one decode step under torch.profiler.

    python3 tools/lm_profile.py          # needs a CUDA card

Region ``train``: ``lm_loss`` forward and backward on 1 x 4,096 tokens
(one of L1's 16 microbatches; each super-block recomputed in the
backward).  Region ``decode``: one ``serve_step`` at batch 64 over a
32,768-slot cache filled by a 512-token prefill (L3's decode).  Each is
run once to warm up, once timed (profiler off), once profiled.  Prints
one JSON line a region: host seconds, the kernels' summed device time and
the share of the host time the card was idle (one stream: the kernels do
not overlap), that device time by class (f32 GEMM:
attention's upcast score and PV products; bf16 GEMM: projections, FFN,
unembed; elementwise; reductions; the rest) and the top kernels; then
the card's name and power limit.  bf16 products accumulate in f32 and
TF32 is off, as in phase L.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

TOP = 12


def kernel_times(prof) -> dict:
    """Self device microseconds by kernel name."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key] = out.get(e.key, 0.0) + us
    return out


def kernel_class(name: str) -> str:
    """By kernel name: cuBLAS names its f32 products ``..._f32f32_...`` or
    ``gemmSN``/``gemv``; on this card it runs the bf16 ones as ``nvjet``."""
    n = name.lower()
    if "nvjet" in n or (("gemm" in n or "xmma" in n or "cutlass" in n)
                        and ("bf16" in n or "bfloat16" in n)):
        return "gemm_bf16"
    if "gemm" in n or "gemv" in n or "xmma" in n:
        return "gemm_f32"
    if "reduce" in n or "softmax" in n or "logsumexp" in n:
        return "reduction"
    if "elementwise" in n or "vectorized" in n or "copy" in n or "fill" in n:
        return "elementwise"
    return "other"


def profile(name, fn, classify=kernel_class) -> dict:
    """A warm-up call, a call timed on the host clock (profiler off), then
    a profiled call for the kernels' device times, summed by
    ``classify(kernel name)``."""
    fn()
    torch.cuda.synchronize()
    t = time.monotonic()
    fn()
    torch.cuda.synchronize()
    host_s = time.monotonic() - t
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    times = kernel_times(prof)
    by_class = {}
    for k, us in times.items():
        c = classify(k)
        by_class[c] = by_class.get(c, 0.0) + us / 1e3
    top = sorted(times.items(), key=lambda kv: -kv[1])[:TOP]
    device_ms = sum(times.values()) / 1e3
    return {"region": name, "host_s": host_s, "device_ms": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / 1e3 / host_s),
            "device_ms_by_class": by_class,
            "top_kernels_ms": [[k[:120], us / 1e3] for k, us in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models.transformer import model as lm

    cfg = get_arch("qwen2-0.5b").cfg
    model = lm.init_params(cfg, device="cuda", seed=0)

    def batch(seed, b, s):
        x = lm_batch(np.random.default_rng(seed), b, s, cfg.vocab)
        return {k: torch.from_numpy(v).cuda() for k, v in x.items()}

    train = batch(0, 1, 4096)

    def train_step():
        lm.lm_loss(model, train).backward()
        model.zero_grad(set_to_none=True)

    print(json.dumps(profile("train", train_step)), flush=True)
    prompt = batch(1, 64, 512)["tokens"]
    logits, cache = lm.prefill(model, prompt, 32_768)
    nxt = logits.argmax(-1)
    pos = [512]

    def decode_step():
        lm.serve_step(model, cache, nxt, pos[0])
        pos[0] += 1

    print(json.dumps(profile("decode", decode_step)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
