#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py                 # every phase, full size
    python3 chip_smoke.py --phases A      # kernel build + parity only

It builds the hand-written kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card, and drives the
port's main path at the paper's scale: a 4,181,504 x 400 Wikipedia-shaped
index (RoundingEncoder(2), int8 codes) served through BatchedSearchEngine
with the ``fused`` engine, trim 0.05, page 320, k 10.

Phases, each printing one JSON line:
  A  the fused_phase1 kernel against its plain version at four shapes
     (scores bit-equal, ids equal where finite, ids in range);
  B  encoders on the card against the CPU (codes equal);
  C  the main path: build, serve 128 noisy corpus rows, check rank-1 hits,
     exact fp32 scores and the kernel's launch count; kernel time, plain
     time and bound at the served shape.
Then the ``kernels`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, and the exit
code is not 0.  Without a CUDA device, or without the ``src/repro_torch``
package beside this file, it prints no result and exits 1.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 33.5e12      # 67 TFLOP/s fp32 non-tensor / 2 per FMA
OPS_PER_ELEMENT = 3                # compare, select, add per (q, doc, col)

N_DOCS = 4_181_504                 # English Wikipedia 4,181,352, padded x512
N_FEATURES = 400
BATCH = 32
N_QUERIES = 128
PAGE = 320
K = 10
NOISE = 0.01


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def progress(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA events,
    after one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fused_bound_ms(d: int, Q: int, C: int, page: int, code_bytes: int,
                   live: bool) -> tuple:
    """Least time for fused_phase1 on these inputs: each input read once,
    each output written once, over the HBM rate; Q*d*C elements at
    OPS_PER_ELEMENT CUDA-core instructions each over the issue rate."""
    nbytes = (d * C * code_bytes + Q * C * (code_bytes + 4)
              + (d if live else 0) + Q * page * 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEMENT * Q * d * C / CUDA_CORE_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def assert_fused_parity(got, want, d, ctx) -> float:
    """Scores bit-equal everywhere, ids equal where finite, ids in range;
    -> max |score difference| over finite entries (0 when bit-equal)."""
    s_g, i_g = got
    s_w, i_w = want
    fin = torch.isfinite(s_w)
    err = float((s_g[fin] - s_w[fin]).abs().max()) if fin.any() else 0.0
    check(torch.equal(s_g, s_w), f"{ctx}: scores differ (max |d|={err})")
    check(torch.equal(i_g[fin], i_w[fin].to(i_g.dtype)),
          f"{ctx}: ids differ where finite")
    check(bool(((i_g >= 0) & (i_g < d)).all()), f"{ctx}: id out of range")
    return err


def phase_a(gen) -> dict:
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel
    from repro_torch.kernels.fused_phase1 import ref as fp_ref

    shapes = [(131072, 8, 400, 320, torch.int8, None),
              (5001, 9, 23, 33, torch.int16, None),
              (700, 5, 37, 17, torch.int32, None),
              (60, 3, 12, 32, torch.int8, 0.3)]
    rows = []
    worst = 0.0
    for d, Q, C, page, dt, live_frac in shapes:
        D = torch.randint(-8, 8, (d, C), generator=gen, device="cuda").to(dt)
        Qc = torch.randint(-8, 8, (Q, C), generator=gen, device="cuda").to(dt)
        W = torch.rand((Q, C), generator=gen, device="cuda")
        live = None
        if live_frac is not None:
            live = torch.rand(d, generator=gen, device="cuda") < live_frac
            check(0 < int(live.sum()) < page, "live case needs < page live")
        got = fp_kernel.fused_phase1_cuda(D, Qc, W, page, live)
        torch.cuda.synchronize()
        want = fp_ref.fused_phase1_ref(D, Qc, W, page, live)
        err = assert_fused_parity(got, want, d, (d, Q, C, page, str(dt)))
        if live is not None:
            n_live = int(live.sum())
            check(bool((torch.isfinite(got[0]).sum(1) == n_live).all()),
                  "live case: finite count != live docs")
        worst = max(worst, err)
        rows.append({"d": d, "Q": Q, "C": C, "page": page,
                     "dtype": str(dt).replace("torch.", ""),
                     "live": live is not None, "max_abs_err": err})
        if len(rows) == 1:
            first = D, Qc, W       # timed below: the slice's C and page
    d, Q, C, page, _, _ = shapes[0]
    D, Qc, W = first
    plain_ms = cuda_ms(lambda: fp_ref.fused_phase1_ref(D, Qc, W, page), 3)
    kernel_ms = cuda_ms(lambda: fp_kernel.fused_phase1_cuda(D, Qc, W, page),
                        5)
    bound, by = fused_bound_ms(d, Q, C, page, 1, False)
    return {"phase": "A", "shapes": rows, "max_abs_err": worst,
            "first_shape": {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
                            "bound_ms": bound, "bound_by": by}}


def phase_b() -> dict:
    from repro_torch.core import encoding as enc

    gen = torch.Generator().manual_seed(1)
    x = torch.randn((65536, N_FEATURES), generator=gen)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    # exact bucket edges and their float neighbours, where a division by
    # width done as a multiply by 1/width would move a code
    edges = torch.arange(-10, 11, dtype=torch.float32) * 0.1
    edges = torch.cat([edges, torch.nextafter(edges, edges + 1),
                       torch.nextafter(edges, edges - 1)])
    x[: edges.numel() // N_FEATURES + 1].view(-1)[: edges.numel()] = edges
    xg = x.cuda()
    encoders = {"RoundingEncoder(2)": enc.RoundingEncoder(2),
                "IntervalEncoder(0.1)": enc.IntervalEncoder(0.1),
                "CombinedEncoder(R1,I0.1)": enc.CombinedEncoder(
                    enc.RoundingEncoder(1), enc.IntervalEncoder(0.1))}
    out = {}
    for name, e in encoders.items():
        cpu = e.encode(x)
        gpu = e.encode(xg).cpu()
        check(cpu.dtype == gpu.dtype, f"{name}: dtype differs")
        out[name] = int((cpu != gpu).sum())
    check(all(v == 0 for v in out.values()), f"encode mismatches {out}")
    return {"phase": "B", "rows": x.shape[0], "mismatches": out}


def phase_c(gen) -> dict:
    from repro_torch.core import RoundingEncoder, TrimFilter, VectorIndex
    from repro_torch.core.rerank import normalize
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel
    from repro_torch.kernels.fused_phase1 import ops as fp_ops
    from repro_torch.kernels.fused_phase1 import ref as fp_ref
    from repro_torch.serve import BatchedSearchEngine

    n_docs = N_DOCS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    vectors = torch.randn((n_docs, N_FEATURES), generator=gen, device="cuda")
    index = VectorIndex.build(vectors, encoder=RoundingEncoder(2),
                              device="cuda")
    del vectors
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    progress(f"index of {n_docs} docs built in {build_s:.1f} s")
    check(index.codes.dtype == torch.int8, "P2 codes must be int8")

    src = torch.randint(0, n_docs, (N_QUERIES,), generator=gen,
                        device="cuda")
    noise = torch.randn((N_QUERIES, N_FEATURES), generator=gen,
                        device="cuda") * NOISE
    queries = (index.vectors[src] + noise).cpu().numpy()
    src = src.cpu()

    engine = BatchedSearchEngine(index, batch_size=BATCH, max_wait_s=0.005,
                                 k=K, page=PAGE, trim=TrimFilter(0.05),
                                 engine="fused")
    batch_s = []
    results = []
    fp_ops.launches = 0
    try:
        for b in range(0, N_QUERIES, BATCH):
            t = time.monotonic()
            futs = [engine.submit(q) for q in queries[b:b + BATCH]]
            results += [f.result(timeout=600) for f in futs]
            batch_s.append(time.monotonic() - t)
            progress(f"batch {b // BATCH} served in {batch_s[-1]:.3f} s")
    finally:
        engine.close()
    launches = fp_ops.launches
    want = fp_kernel.KERNELS_PER_CALL * (N_QUERIES // BATCH)
    check(launches >= want,
          f"fused_phase1 launched {launches} CUDA kernels for "
          f"{N_QUERIES // BATCH} batches, want at least {want}")

    ids = torch.from_numpy(np.stack([r[0] for r in results]))
    scores = torch.from_numpy(np.stack([r[1] for r in results]))
    check(ids.shape == (N_QUERIES, K) and scores.shape == (N_QUERIES, K),
          "result shapes")
    check(bool(((ids >= 0) & (ids < n_docs)).all()), "id out of range")
    check(bool(torch.isfinite(scores).all()), "non-finite score")
    rank1 = float((ids[:, 0].long() == src).float().mean())
    check(rank1 >= 0.95, f"source doc at rank 1 for only {rank1:.3f}")
    qn = normalize(torch.from_numpy(queries).cuda())
    exact = torch.einsum("qkn,qn->qk", index.vectors[ids.long().cuda()], qn)
    score_err = float((exact.cpu() - scores).abs().max())
    check(score_err <= 1e-5, f"scores off the exact cosine by {score_err}")
    gold_ids, _ = index.gold_topk(torch.from_numpy(queries).cuda(), k=K)
    gold = gold_ids.cpu()
    recall = sum(len(set(ids[i].tolist()) & set(gold[i].tolist()))
                 for i in range(N_QUERIES)) / (N_QUERIES * K)

    # the kernel alone at the served shape, against its plain version
    q, qcodes, w = index.encode_queries(
        torch.from_numpy(queries[:BATCH]).cuda(), TrimFilter(0.05), None,
        "idf")
    got = fp_kernel.fused_phase1_cuda(index.codes, qcodes, w, PAGE)
    torch.cuda.synchronize()
    t = time.monotonic()
    want = fp_ref.fused_phase1_stream(index.codes, qcodes, w, PAGE,
                                      block=16384)
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - t) * 1e3
    err = assert_fused_parity(got, want, n_docs, "served shape")
    progress(f"kernel matches plain at the served shape ({plain_ms:.0f} ms "
             "plain)")
    kernel_ms = cuda_ms(
        lambda: fp_kernel.fused_phase1_cuda(index.codes, qcodes, w, PAGE), 3)
    bound, by = fused_bound_ms(n_docs, BATCH, index.codes.shape[1], PAGE, 1,
                               False)
    lat = sorted(batch_s[1:])
    return {"phase": "C", "n_docs": n_docs, "n_features": N_FEATURES,
            "build_s": build_s, "batch_latency_s_median": lat[len(lat) // 2],
            "batch_latency_s": batch_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": launches, "rank1_share": rank1,
            "score_max_abs_err": score_err, "recall_at_10_vs_gold": recall,
            "kernel": {"Q": BATCH, "ms": kernel_ms, "plain_ms": plain_ms,
                       "max_abs_err": err, "bound_ms": bound,
                       "bound_by": by}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="ABC")
    args = ap.parse_args(argv)

    src = pathlib.Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t = time.monotonic()
    fp_kernel.library()
    build_s = time.monotonic() - t
    log = _build.build_dir() / "fused_phase1.log"
    emit({"device": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "ptxas": [ln for ln in (log.read_text().splitlines()
                                  if log.exists() else [])
                    if "registers" in ln or "spill" in ln]})

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = c = None
    if "A" in args.phases:
        a = phase_a(gen)
        emit(a)
    if "B" in args.phases:
        emit(phase_b())
    if "C" in args.phases:
        c = phase_c(gen)
        emit(c)
    ck = c["kernel"] if c else (a["first_shape"] if a else {})
    emit({"kernels": [{
        "name": "fused_phase1", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_phase1/csrc/fused_phase1.cu",
        "replaces": "src/repro/kernels/fused_phase1/kernel.py:133",
        "launches": c["launches"] if c else 0,
        "max_abs_err": max(a["max_abs_err"] if a else 0.0,
                           ck.get("max_abs_err", 0.0)),
        "ms": ck.get("ms", ck.get("kernel_ms")),
        "plain_ms": ck.get("plain_ms"), "bound_ms": ck.get("bound_ms"),
        "bound_by": ck.get("bound_by"), "library_ms": None,
        "checked_vs_plain": a is not None or c is not None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
