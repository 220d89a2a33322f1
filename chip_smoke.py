#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py                 # every phase, full size
    python3 chip_smoke.py --phases A      # kernel build + parity only

It builds the hand-written kernels from the sources in this checkout (one
nvcc per library, all started together), holds each against its plain
PyTorch version on the card, and drives the port's search paths at the
paper's scale: a 4,181,504 x 400 Wikipedia-shaped index
(RoundingEncoder(2), int8 codes), trim 0.05, page 320, k 10.

Phases, each printing one JSON line (D one per engine, then a summary):
  A  each kernel against its plain version: fused_phase1 (scores
     bit-equal, ids equal where finite), code_match (rtol/atol 1e-5, and
     bit-equal to the match_scores tree) and fused_phase1_quant (scores
     within rtol 1e-5 / atol 1e-4, ids equal away from near-ties), ids in
     range, at four shapes or more each, page = d = 5000 included;
  B  encoders and the int8 quant table on the card against the CPU (codes,
     scale and zero bit-equal);
  C  the ``fused`` path: build, serve 128 noisy corpus rows through
     BatchedSearchEngine(engine="fused"), check rank-1 hits, exact fp32
     scores and the kernel's launch count; kernel time, plain time and
     bound at the served shape;
  D  every other engine on phase C's index: BatchedSearchEngine with no
     engine named (``codes``), ``codes_pallas`` and ``fused_int8`` (128
     rows each), ``index.search`` with no engine named (``postings``, 32
     rows), and ``onehot`` on the first 65,536 rows (32 rows); the same
     checks, the kernels' launch counts, and each new kernel's time, plain
     time and bound at Q 32.
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
ONEHOT_DOCS = 65_536               # onehot's (d, C*201) table, cut to size


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


def code_match_bound_ms(d: int, Q: int, C: int, code_bytes: int) -> tuple:
    """Least time for code_match: the codes and queries read once, the
    (Q, d) f32 matrix written once; Q*d*C elements at OPS_PER_ELEMENT
    CUDA-core instructions each."""
    nbytes = d * C * code_bytes + Q * C * (code_bytes + 4) + Q * d * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEMENT * Q * d * C / CUDA_CORE_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def quant_bound_ms(d: int, Q: int, n: int, page: int, live: bool) -> tuple:
    """Least time for fused_phase1_quant: the int8 rows, scale, zero and
    queries read once, the page written once; Q*d*n fp32 multiply-adds on
    the CUDA cores (the f32 queries keep it off the tensor cores)."""
    nbytes = d * n + 8 * d + (d if live else 0) + Q * n * 4 + Q * page * 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = Q * d * n / CUDA_CORE_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def host_ms(fn) -> float:
    """Milliseconds of one call of ``fn`` on the host clock, synchronised
    before and after."""
    torch.cuda.synchronize()
    t = time.monotonic()
    fn()
    torch.cuda.synchronize()
    return (time.monotonic() - t) * 1e3


def assert_quant_parity(got, want, d, ctx, tol=1e-4) -> float:
    """The fused int8 contract: scores within rtol 1e-5 / atol 1e-4, ids
    equal wherever the plain version separates neighbours by more than
    1e-4, ids in range; -> max |score difference| over finite entries."""
    s_g, i_g = (t.cpu().numpy() for t in got)
    s_w, i_w = (t.cpu().numpy() for t in want)
    fin = np.isfinite(s_w)
    check(np.array_equal(fin, np.isfinite(s_g)), f"{ctx}: -inf slots differ")
    err = float(np.abs(s_g[fin] - s_w[fin]).max()) if fin.any() else 0.0
    check(bool(np.all(np.abs(s_g[fin] - s_w[fin])
                      <= tol + 1e-5 * np.abs(s_w[fin]))),
          f"{ctx}: scores off by {err}")
    sep = fin.copy()
    if s_w.shape[1] > 1:
        with np.errstate(invalid="ignore"):
            tie = np.abs(s_w[:, :-1] - s_w[:, 1:]) <= tol
        sep[:, 1:] &= ~tie
        sep[:, :-1] &= ~tie
    check(np.array_equal(i_g[sep], i_w[sep]), f"{ctx}: ids differ")
    check(bool(((i_g >= 0) & (i_g < d)).all()), f"{ctx}: id out of range")
    return err


def code_match_plain(D, Qc, W, block=32768):
    """The plain version at any size: code_match_ref a doc block at a
    time, so no (Q, d, C) tensor exists."""
    from repro_torch.kernels.code_match import ref as cm_ref

    out = torch.empty((Qc.shape[0], D.shape[0]), device=D.device)
    for lo in range(0, D.shape[0], block):
        out[:, lo:lo + block] = cm_ref.code_match_ref(D[lo:lo + block], Qc,
                                                      W)
    return out


def assert_code_match_close(got, want, ctx) -> float:
    err = float((got - want).abs().max())
    check(bool(torch.isclose(got, want, rtol=1e-5, atol=1e-5).all()),
          f"{ctx}: code_match off the plain version by {err}")
    return err


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
    # page = d = 5000: past the old 1024 limit
    D = torch.randint(-8, 8, (5000, 400), generator=gen,
                      device="cuda").to(torch.int8)
    Qc = torch.randint(-8, 8, (4, 400), generator=gen,
                       device="cuda").to(torch.int8)
    W = torch.rand((4, 400), generator=gen, device="cuda")
    got = fp_kernel.fused_phase1_cuda(D, Qc, W, 5000)
    torch.cuda.synchronize()
    err = assert_fused_parity(got, fp_ref.fused_phase1_ref(D, Qc, W, 5000),
                              5000, "page = d = 5000")
    check(bool(torch.isfinite(got[0]).all()), "page 5000: -inf slot")
    worst = max(worst, err)
    rows.append({"d": 5000, "Q": 4, "C": 400, "page": 5000,
                 "dtype": "int8", "live": False, "max_abs_err": err})
    d, Q, C, page, _, _ = shapes[0]
    D, Qc, W = first
    plain_ms = cuda_ms(lambda: fp_ref.fused_phase1_ref(D, Qc, W, page), 3)
    kernel_ms = cuda_ms(lambda: fp_kernel.fused_phase1_cuda(D, Qc, W, page),
                        5)
    bound, by = fused_bound_ms(d, Q, C, page, 1, False)
    return {"phase": "A", "kernel": "fused_phase1", "shapes": rows,
            "max_abs_err": worst,
            "first_shape": {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
                            "bound_ms": bound, "bound_by": by}}


def phase_a_code_match(gen) -> dict:
    from repro_torch.kernels.code_match import kernel as cm_kernel
    from repro_torch.kernels.fused_phase1 import ref as fp_ref

    shapes = [(131072, 8, 400, torch.int8), (5001, 9, 23, torch.int16),
              (700, 5, 37, torch.int32), (1031, 3, 96, torch.int16),
              (3000, 40, 800, torch.int8)]
    rows = []
    worst = 0.0
    for d, Q, C, dt in shapes:
        hi = 100 if dt == torch.int8 else 3000
        D = torch.randint(-hi, hi, (d, C), generator=gen,
                          device="cuda").to(dt)
        Qc = D[torch.randint(0, d, (Q,), generator=gen, device="cuda")]
        Qc[:, ::3] = torch.randint(-hi, hi, Qc[:, ::3].shape, generator=gen,
                                   device="cuda").to(dt)
        W = torch.rand((Q, C), generator=gen, device="cuda")
        got = cm_kernel.code_match_cuda(D, Qc, W)
        torch.cuda.synchronize()
        err = assert_code_match_close(got, code_match_plain(D, Qc, W),
                                      (d, Q, C, str(dt)))
        check(torch.equal(got, fp_ref.match_scores(D, Qc, W)),
              f"{(d, Q, C, str(dt))}: not bit-equal to match_scores")
        worst = max(worst, err)
        rows.append({"d": d, "Q": Q, "C": C,
                     "dtype": str(dt).replace("torch.", ""),
                     "max_abs_err": err})
    return {"phase": "A", "kernel": "code_match", "shapes": rows,
            "max_abs_err": worst}


def quant_inputs(gen, d, n, Q):
    from repro_torch.core import quantize as tq

    V = torch.randn((d, n), generator=gen, device="cuda") * (
        0.1 + 3.9 * torch.rand((d, 1), generator=gen, device="cuda"))
    codes, scale, zero = tq.quantize_rows(V)
    return codes, scale, zero, torch.randn((Q, n), generator=gen,
                                           device="cuda")


def phase_a_quant(gen) -> dict:
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel
    from repro_torch.kernels.fused_phase1 import ref as fp_ref

    shapes = [(131072, 400, 8, 320, None), (5001, 23, 9, 33, None),
              (90, 12, 3, 48, 0.3), (5000, 400, 4, 5000, None),
              (3000, 401, 40, 1024, 0.9)]
    rows = []
    worst = 0.0
    for d, n, Q, page, live_frac in shapes:
        codes, scale, zero, q = quant_inputs(gen, d, n, Q)
        live = None
        if live_frac is not None:
            live = torch.rand(d, generator=gen, device="cuda") < live_frac
        got = fp_kernel.fused_phase1_quant_cuda(codes, scale, zero, q, page,
                                                live)
        torch.cuda.synchronize()
        want = fp_ref.fused_phase1_quant_ref(codes, scale, zero, q, page,
                                             live)
        err = assert_quant_parity(got, want, d, (d, n, Q, page))
        if live is not None and int(live.sum()) < page:
            check(bool((torch.isfinite(got[0]).sum(1)
                        == int(live.sum())).all()),
                  "live case: finite count != live docs")
        worst = max(worst, err)
        rows.append({"d": d, "n": n, "Q": Q, "page": page,
                     "live": live is not None, "max_abs_err": err})
    return {"phase": "A", "kernel": "fused_phase1_quant", "shapes": rows,
            "max_abs_err": worst}


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
    from repro_torch.core import quantize as tq

    # the int8 table at mixed row scales, degenerate rows included
    xq = x * (0.05 + 5 * torch.rand((x.shape[0], 1), generator=gen))
    xq[-2] = 0.0
    xq[-1] = 1.75
    cpu = tq.quantize_table(xq)
    card = tq.quantize_table(xq.cuda())
    quant = {name: int((getattr(cpu, name) != getattr(card, name).cpu())
                       .sum()) for name in ("codes", "scale", "zero")}
    check(all(v == 0 for v in quant.values()), f"quant mismatches {quant}")
    return {"phase": "B", "rows": x.shape[0], "mismatches": out,
            "quant_mismatches": quant}


def serve_check(index, queries, src, results, ctx) -> dict:
    """The end-to-end checks of one served engine: shapes, ids in range,
    finite scores, the source row at rank 1 for >= 0.95 of the queries,
    reported scores within 1e-5 of a fresh fp32 cosine."""
    from repro_torch.core.rerank import normalize

    n = len(results)
    ids = torch.from_numpy(np.stack([r[0] for r in results]))
    scores = torch.from_numpy(np.stack([r[1] for r in results]))
    check(ids.shape == (n, K) and scores.shape == (n, K),
          f"{ctx}: result shapes")
    check(bool(((ids >= 0) & (ids < index.n_docs)).all()),
          f"{ctx}: id out of range")
    check(bool(torch.isfinite(scores).all()), f"{ctx}: non-finite score")
    rank1 = float((ids[:, 0].long() == src).float().mean())
    check(rank1 >= 0.95, f"{ctx}: source doc at rank 1 for only {rank1:.3f}")
    qn = normalize(torch.from_numpy(queries).cuda())
    exact = torch.einsum("qkn,qn->qk", index.vectors[ids.long().cuda()], qn)
    score_err = float((exact.cpu() - scores).abs().max())
    check(score_err <= 1e-5, f"{ctx}: scores off the exact cosine by "
          f"{score_err}")
    return {"rank1_share": rank1, "score_max_abs_err": score_err}


def serve_engine(index, queries, ctx, **engine_kw):
    """Serve ``queries`` through BatchedSearchEngine in batches of BATCH
    -> (results, per-batch seconds, peak device bytes)."""
    from repro_torch.core import TrimFilter
    from repro_torch.serve import BatchedSearchEngine

    torch.cuda.reset_peak_memory_stats()
    engine = BatchedSearchEngine(index, batch_size=BATCH, max_wait_s=0.005,
                                 k=K, page=PAGE, trim=TrimFilter(0.05),
                                 **engine_kw)
    batch_s, results = [], []
    try:
        for b in range(0, len(queries), BATCH):
            t = time.monotonic()
            futs = [engine.submit(q) for q in queries[b:b + BATCH]]
            results += [f.result(timeout=600) for f in futs]
            batch_s.append(time.monotonic() - t)
            progress(f"{ctx}: batch {b // BATCH} served in "
                     f"{batch_s[-1]:.3f} s")
    finally:
        engine.close()
    return results, batch_s, torch.cuda.max_memory_allocated()


def median_after_first(xs):
    lat = sorted(xs[1:] or xs)
    return lat[len(lat) // 2]


def reset_launches() -> None:
    from repro_torch.kernels.code_match import ops as cm_ops
    from repro_torch.kernels.fused_phase1 import ops as fp_ops

    fp_ops.launches = fp_ops.quant_launches = cm_ops.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels.code_match import ops as cm_ops
    from repro_torch.kernels.fused_phase1 import ops as fp_ops

    return {"fused_phase1": fp_ops.launches,
            "fused_phase1_quant": fp_ops.quant_launches,
            "code_match": cm_ops.launches}


def phase_c(gen) -> tuple:
    from repro_torch.core import RoundingEncoder, TrimFilter, VectorIndex
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel
    from repro_torch.kernels.fused_phase1 import ops as fp_ops
    from repro_torch.kernels.fused_phase1 import ref as fp_ref

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

    build_peak = torch.cuda.max_memory_allocated()
    reset_launches()
    results, batch_s, _ = serve_engine(index, queries, "fused",
                                       engine="fused")
    launches = fp_ops.launches
    want = fp_kernel.KERNELS_PER_CALL * (N_QUERIES // BATCH)
    check(launches >= want,
          f"fused_phase1 launched {launches} CUDA kernels for "
          f"{N_QUERIES // BATCH} batches, want at least {want}")
    served = serve_check(index, queries, src, results, "fused")
    ids = np.stack([r[0] for r in results])
    gold_ids, _ = index.gold_topk(torch.from_numpy(queries).cuda(), k=K)
    gold = gold_ids.cpu().numpy()
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
    return {"phase": "C", "n_docs": n_docs, "n_features": N_FEATURES,
            "build_s": build_s,
            "batch_latency_s_median": median_after_first(batch_s),
            "batch_latency_s": batch_s,
            "max_memory_allocated": max(build_peak,
                                        torch.cuda.max_memory_allocated()),
            "launches": launches, **served, "recall_at_10_vs_gold": recall,
            "kernel": {"Q": BATCH, "ms": kernel_ms, "plain_ms": plain_ms,
                       "max_abs_err": err, "bound_ms": bound,
                       "bound_by": by}}, index, queries, src


def phase_d(gen, index, queries, src) -> tuple:
    """Every other engine on phase C's index; -> (summary line, the
    ``kernels`` entries of code_match and fused_phase1_quant)."""
    import inspect

    from repro_torch.core import TrimFilter, VectorIndex
    from repro_torch.kernels.code_match import kernel as cm_kernel
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel
    from repro_torch.kernels.fused_phase1 import ref as fp_ref
    from repro_torch.serve import BatchedSearchEngine

    check(inspect.signature(BatchedSearchEngine).parameters["engine"]
          .default == "codes", "BatchedSearchEngine default is not codes")
    check(inspect.signature(VectorIndex.search).parameters["engine"]
          .default == "postings", "VectorIndex.search default is not "
          "postings")
    per_batch = N_QUERIES // BATCH
    want_launches = {"codes": {},
                     "codes_pallas": {"code_match":
                                      cm_kernel.KERNELS_PER_CALL
                                      * per_batch},
                     "fused_int8": {"fused_phase1_quant":
                                    fp_kernel.KERNELS_PER_CALL * per_batch}}
    engines = {}
    launches = {}
    for name in ("codes", "codes_pallas", "fused_int8"):
        kw = {} if name == "codes" else {"engine": name}
        reset_launches()
        results, batch_s, peak = serve_engine(index, queries, name, **kw)
        got = read_launches()
        for kname, n in want_launches[name].items():
            check(got[kname] >= n, f"{name}: {kname} launched {got[kname]} "
                  f"CUDA kernels for {per_batch} batches, want {n}")
            launches[kname] = got[kname]
        row = {"engine": name, "engine_named": bool(kw),
               "batch_latency_s_median": median_after_first(batch_s),
               "batch_latency_s": batch_s, "max_memory_allocated": peak,
               "launches": got,
               **serve_check(index, queries, src, results, name)}
        engines[name] = row
        emit({"phase": "D", **row})

    # index.search with no engine named: postings, exact
    qs = torch.from_numpy(queries[:BATCH])
    lat = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        t = time.monotonic()
        ids, scores = index.search(qs, k=K, page=PAGE, trim=TrimFilter(0.05))
        torch.cuda.synchronize()
        lat.append(time.monotonic() - t)
        progress(f"postings: batch served in {lat[-1]:.3f} s")
    row = {"engine": "postings", "engine_named": False, "queries": BATCH,
           "batch_latency_s": lat, "batch_latency_s_median": lat[-1],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           **serve_check(index, queries[:BATCH], src[:BATCH],
                         list(zip(ids.cpu().numpy(), scores.cpu().numpy())),
                         "postings")}
    engines["postings"] = row
    emit({"phase": "D", **row})

    # onehot on the first ONEHOT_DOCS rows: its (d, C * 201) one-hot table
    # is walked a block at a time, but a full-size pass is out of budget
    small = VectorIndex.build(index.vectors[:ONEHOT_DOCS],
                              encoder=index.encoder, device="cuda")
    s_src = torch.randint(0, ONEHOT_DOCS, (BATCH,), generator=gen,
                          device="cuda")
    s_q = (small.vectors[s_src] + torch.randn(
        (BATCH, N_FEATURES), generator=gen, device="cuda") * NOISE)
    s_q = s_q.cpu().numpy()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(2):
        t = time.monotonic()
        ids, scores = small.search(torch.from_numpy(s_q), k=K, page=PAGE,
                                   trim=TrimFilter(0.05), engine="onehot")
        torch.cuda.synchronize()
        lat.append(time.monotonic() - t)
    row = {"engine": "onehot", "engine_named": True, "queries": BATCH,
           "n_docs": ONEHOT_DOCS,
           "cut": f"index of the first {ONEHOT_DOCS} of {index.n_docs} rows",
           "batch_latency_s": lat, "batch_latency_s_median": lat[-1],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           **serve_check(small, s_q, s_src.cpu(),
                         list(zip(ids.cpu().numpy(), scores.cpu().numpy())),
                         "onehot")}
    engines["onehot"] = row
    emit({"phase": "D", **row})
    del small

    # the two new kernels alone at Q 32 on the served index
    q, qcodes, w = index.encode_queries(qs.cuda(), TrimFilter(0.05), None,
                                        "idf")
    got = cm_kernel.code_match_cuda(index.codes, qcodes, w)
    plain = code_match_plain(index.codes, qcodes, w)
    cm_err = assert_code_match_close(got, plain, "code_match served shape")
    del got, plain
    cm_plain_ms = host_ms(lambda: code_match_plain(index.codes, qcodes, w))
    cm_ms = cuda_ms(lambda: cm_kernel.code_match_cuda(index.codes, qcodes,
                                                      w), 3)
    cm_bound, cm_by = code_match_bound_ms(index.n_docs, BATCH,
                                          index.codes.shape[1], 1)
    qt = index.quantized
    got = fp_kernel.fused_phase1_quant_cuda(qt.codes, qt.scale, qt.zero, q,
                                            PAGE)
    want = fp_ref.fused_phase1_quant_ref(qt.codes, qt.scale, qt.zero, q,
                                         PAGE)
    qn_err = assert_quant_parity(got, want, index.n_docs, "quant served "
                                 "shape")
    qn_plain_ms = host_ms(lambda: fp_ref.fused_phase1_quant_ref(
        qt.codes, qt.scale, qt.zero, q, PAGE))
    qn_ms = cuda_ms(lambda: fp_kernel.fused_phase1_quant_cuda(
        qt.codes, qt.scale, qt.zero, q, PAGE), 3)
    qn_bound, qn_by = quant_bound_ms(index.n_docs, BATCH, N_FEATURES, PAGE,
                                     False)
    kernels = {
        "code_match": {"launches": launches["code_match"],
                       "max_abs_err": cm_err, "ms": cm_ms,
                       "plain_ms": cm_plain_ms, "bound_ms": cm_bound,
                       "bound_by": cm_by},
        "fused_phase1_quant": {"launches": launches["fused_phase1_quant"],
                               "max_abs_err": qn_err, "ms": qn_ms,
                               "plain_ms": qn_plain_ms, "bound_ms": qn_bound,
                               "bound_by": qn_by}}
    summary = {"phase": "D", "n_docs": index.n_docs,
               "batch_latency_s_median": {
                   k: v["batch_latency_s_median"] for k, v in engines.items()},
               "max_memory_allocated": {
                   k: v["max_memory_allocated"] for k, v in engines.items()},
               "kernels_at_Q32": kernels}
    return summary, kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="ABCD")
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

    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    from repro_torch.kernels.code_match import kernel as cm_kernel
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t = time.monotonic()
    builds = {"fused_phase1": fp_kernel.library,
              "fused_phase1_quant": fp_kernel.quant_library,
              "code_match": cm_kernel.library}
    with ThreadPoolExecutor(len(builds)) as pool:   # one nvcc each, at once
        for f in [pool.submit(fn) for fn in builds.values()]:
            f.result()
    build_s = time.monotonic() - t
    ptxas = {}
    for name in builds:
        log = _build.build_dir() / f"{name}.log"
        ptxas[name] = [ln for ln in (log.read_text().splitlines()
                                     if log.exists() else [])
                       if "registers" in ln or "spill" in ln]
    emit({"device": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas})

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = c = None
    a_err = {}
    kd = {}
    if "A" in args.phases:
        a = phase_a(gen)
        emit(a)
        for line in (phase_a_code_match(gen), phase_a_quant(gen)):
            emit(line)
            a_err[line["kernel"]] = line["max_abs_err"]
    if "B" in args.phases:
        emit(phase_b())
    if "C" in args.phases:
        c, index, queries, src = phase_c(gen)
        emit(c)
        if "D" in args.phases:
            summary, kd = phase_d(gen, index, queries, src)
            emit(summary)
        del index
    ck = c["kernel"] if c else (a["first_shape"] if a else {})
    entries = [{
        "name": "fused_phase1", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_phase1/csrc/fused_phase1.cu",
        "replaces": "src/repro/kernels/fused_phase1/kernel.py:133",
        "launches": c["launches"] if c else 0,
        "max_abs_err": max(a["max_abs_err"] if a else 0.0,
                           ck.get("max_abs_err", 0.0)),
        "ms": ck.get("ms", ck.get("kernel_ms")),
        "plain_ms": ck.get("plain_ms"), "bound_ms": ck.get("bound_ms"),
        "bound_by": ck.get("bound_by"), "library_ms": None}]
    for name, source, replaces in (
            ("code_match",
             "src/repro_torch/kernels/code_match/csrc/code_match.cu",
             "src/repro/kernels/code_match/kernel.py:49"),
            ("fused_phase1_quant",
             "src/repro_torch/kernels/fused_phase1/csrc/"
             "fused_phase1_quant.cu",
             "src/repro/kernels/fused_phase1/kernel.py:154")):
        k = kd.get(name, {})
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": k.get("launches", 0),
            "max_abs_err": max(a_err.get(name, 0.0),
                               k.get("max_abs_err", 0.0)),
            "ms": k.get("ms"), "plain_ms": k.get("plain_ms"),
            "bound_ms": k.get("bound_ms"), "bound_by": k.get("bound_by"),
            "library_ms": None})
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
