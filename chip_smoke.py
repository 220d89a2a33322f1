#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py                 # every phase, full size
    python3 chip_smoke.py --phases A      # kernel build + parity only

It builds the hand-written kernels from the sources in this checkout (one
nvcc per library, all started together), holds each against its plain
PyTorch version on the card, drives the port's search paths at the
paper's scale -- a 4,181,504 x 400 Wikipedia-shaped index
(RoundingEncoder(2), int8 codes), trim 0.05, page 320, k 10 -- and runs
the paper's quality pipeline on the card.

Phases, each printing one JSON line (D one per engine, then a summary):
  A  each kernel against its plain version: fused_phase1 (scores
     bit-equal, ids equal where finite), code_match (rtol/atol 1e-5, and
     bit-equal to the match_scores tree) and fused_phase1_quant (scores
     within rtol 1e-5 / atol 1e-4, ids equal away from near-ties), ids in
     range, at four shapes or more each, page = d = 5000 and page 16,384
     (the fold in device memory) included; rerank_topk (rtol 1e-4 / atol
     5e-5) at five shapes, page 8192 and ragged n included; bucketize
     (>= 99.99% of codes equal, the rest one bucket off) in both modes,
     int8 and int16, ragged rows;
  B  encoders and the int8 quant table on the card against the CPU (codes,
     scale and zero bit-equal);
  C  the ``fused`` path: build, serve 128 noisy corpus rows through
     BatchedSearchEngine(engine="fused"), check rank-1 hits, exact fp32
     scores and the kernel's launch count; kernel time, plain time and
     bound at the served shape;
  D  every other engine on phase C's index: BatchedSearchEngine with no
     engine named (``codes``), ``codes_pallas`` and ``fused_int8`` (128
     rows each), ``index.search`` with no engine named (``postings``, 32
     rows, served twice: both answers, and two runs of its phase-1
     scores, bit-equal), and ``onehot`` on the first 65,536 rows (32
     rows); the same checks, the kernels' launch counts, and each
     kernel's time, plain time and bound at Q 32; then
     ``bucketize.ops.encode`` of the raw 4,181,504 x 400 rows held to
     ``index.codes`` (the encode_4m cell of
     ``src/repro/configs/vectordb_wiki.py``), and
     ``rerank_topk.ops.rerank_topk`` on the served candidates at page 320
     and 8192 held to ``core.rerank.rerank_topk``, with its gathered
     signature (``ops.rerank_scores`` on pre-gathered rows) timed beside
     the einsum on the same rows;
  E  the paper's quality path: make_corpus (262,144 docs, vocabulary
     100,000, 400 topics) -> build_lsa(400) on the card -> VectorIndex
     (CombinedEncoder(P1, I10)) with bucketize held to its codes -> P@10,
     nDCG and avg.diff of ``codes``, ``fused`` and More-Like-This against
     brute force, the claims C1-C5 of tests/test_quality_claims.py, and
     rerank_topk on the ``fused`` candidates; the LSA is built twice and
     the MLT scores taken twice, each pair bit-equal.
Then the ``kernels`` line (with each library's largest ptxas stack frame
of a kernel: 0 bytes for the code-match scorers, checked), the card's
name and power limit, and last
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
E_DOCS = 262_144                   # phase E corpus, cut from 4,181,352
E_VOCAB = 100_000                  # gensim make_wiki: keep_n=100000
E_TOPICS = 400
E_QUERIES = 128
E_EXACT_QUERIES = 16               # C4 at page = n_docs: (16, d, 400) rescore


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


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` without the host's share: after
    one warm-up call, ``reps`` calls are captured in one CUDA graph, which
    is replayed once (warm) and then once between CUDA events."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
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


def bucketize_bound_ms(B: int, n: int, code_bytes: int) -> tuple:
    """Least time for bucketize: each f32 element read once, its code
    written once; a few operations an element, far below the bytes."""
    t_bytes = B * n * (4 + code_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * B * n / CUDA_CORE_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rerank_bound_ms(ids: torch.Tensor, n: int) -> tuple:
    """Least time for rerank_scores on these ids: each distinct candidate
    row read once, the ids and queries read once, the scores written once;
    one FMA per (query, candidate, feature)."""
    Q, P = ids.shape
    rows = int(torch.unique(ids).numel())
    nbytes = rows * n * 4 + Q * P * 4 + Q * n * 4 + Q * P * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = Q * P * n / CUDA_CORE_OPS_PER_S * 1e3
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
    that same tolerance (tol + 1e-5 |s|: at |s| ~ 180 a legal difference
    of 1e-4 swaps neighbours 1.2e-4 apart), ids in range; -> max |score
    difference| over finite entries.  ``want`` may hold one column more
    than ``got`` (the plain version at page + 1), so that a near-tie
    across the page's last slot counts as one."""
    s_g, i_g = (t.cpu().numpy() for t in got)
    s_w, i_w = (t.cpu().numpy() for t in want)
    page = s_g.shape[1]
    sep = np.isfinite(s_w)
    if s_w.shape[1] > 1:
        with np.errstate(invalid="ignore"):
            tie = (np.abs(s_w[:, :-1] - s_w[:, 1:])
                   <= tol + 1e-5 * np.abs(s_w[:, :-1]))
        sep[:, 1:] &= ~tie
        sep[:, :-1] &= ~tie
    s_w, i_w, sep = s_w[:, :page], i_w[:, :page], sep[:, :page]
    fin = np.isfinite(s_w)
    check(np.array_equal(fin, np.isfinite(s_g)), f"{ctx}: -inf slots differ")
    err = float(np.abs(s_g[fin] - s_w[fin]).max()) if fin.any() else 0.0
    check(bool(np.all(np.abs(s_g[fin] - s_w[fin])
                      <= tol + 1e-5 * np.abs(s_w[fin]))),
          f"{ctx}: scores off by {err}")
    bad = np.argwhere(sep & (i_g != i_w))
    near = [(s_w[q, max(j - 1, 0):j + 2].tolist(),
             s_g[q, max(j - 1, 0):j + 2].tolist()) for q, j in bad[:2]]
    check(bad.size == 0, f"{ctx}: ids differ at (query, slot) "
          f"{bad[:4].tolist()}; (plain, kernel) scores around: {near}")
    check(bool(((i_g >= 0) & (i_g < d)).all()), f"{ctx}: id out of range")
    return err


def stack_frames(log_lines) -> dict:
    """{mangled kernel name: bytes of its stack frame} from a library's
    ``nvcc -Xptxas -v`` log."""
    out, fn = {}, None
    for ln in log_lines:
        if "Function properties for" in ln:
            fn = ln.rsplit(" ", 1)[-1]
        elif "bytes stack frame" in ln and fn is not None:
            if "kernel" in fn:
                out[fn] = int(ln.split()[0])
            fn = None
    return out


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
    # page 16,384: the accumulator and tile in the device workspace
    D = torch.randint(-8, 8, (65536, 400), generator=gen,
                      device="cuda").to(torch.int8)
    Qc = torch.randint(-8, 8, (8, 400), generator=gen,
                       device="cuda").to(torch.int8)
    W = torch.rand((8, 400), generator=gen, device="cuda")
    got = fp_kernel.fused_phase1_cuda(D, Qc, W, 16384)
    torch.cuda.synchronize()
    err = assert_fused_parity(got, fp_ref.fused_phase1_ref(D, Qc, W, 16384),
                              65536, "page 16384")
    worst = max(worst, err)
    rows.append({"d": 65536, "Q": 8, "C": 400, "page": 16384,
                 "dtype": "int8", "live": False, "max_abs_err": err,
                 "ms": cuda_ms(lambda: fp_kernel.fused_phase1_cuda(
                     D, Qc, W, 16384), 2)})
    del D, Qc, W, got
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
              (3000, 401, 40, 1024, 0.9), (65536, 400, 8, 16384, None)]
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
        want = fp_ref.fused_phase1_quant_ref(codes, scale, zero, q,
                                             min(page + 1, d), live)
        err = assert_quant_parity(got, want, d, (d, n, Q, page))
        if live is not None and int(live.sum()) < page:
            check(bool((torch.isfinite(got[0]).sum(1)
                        == int(live.sum())).all()),
                  "live case: finite count != live docs")
        worst = max(worst, err)
        rows.append({"d": d, "n": n, "Q": Q, "page": page,
                     "live": live is not None, "max_abs_err": err})
        if page > 8192:        # the fold in device memory: timed
            rows[-1]["ms"] = cuda_ms(
                lambda: fp_kernel.fused_phase1_quant_cuda(codes, scale, zero,
                                                          q, page), 2)
    return {"phase": "A", "kernel": "fused_phase1_quant", "shapes": rows,
            "max_abs_err": worst}


def phase_a_rerank(gen) -> dict:
    from repro_torch.core.rerank import normalize
    from repro_torch.kernels.rerank_topk import kernel as rk_kernel
    from repro_torch.kernels.rerank_topk import ref as rk_ref

    shapes = [(131072, 32, 320, 400), (131072, 32, 8192, 400),
              (5000, 9, 777, 37), (1000, 3, 50, 401), (64, 1, 1, 1)]
    rows = []
    worst = 0.0
    for d, Q, P, n in shapes:
        V = normalize(torch.randn((d, n), generator=gen, device="cuda"))
        ids = torch.randint(0, d, (Q, P), generator=gen, device="cuda",
                            dtype=torch.int32)
        q = normalize(torch.randn((Q, n), generator=gen, device="cuda"))
        got = rk_kernel.rerank_scores_cuda(V, ids, q)
        torch.cuda.synchronize()
        want = rk_ref.candidate_scores_ref(V, ids, q)
        err = float((got - want).abs().max())
        check(bool(torch.isclose(got, want, rtol=1e-4, atol=5e-5).all()),
              f"rerank {(d, Q, P, n)}: off the plain version by {err}")
        worst = max(worst, err)
        rows.append({"d": d, "Q": Q, "P": P, "n": n, "max_abs_err": err})
    return {"phase": "A", "kernel": "rerank_topk", "shapes": rows,
            "max_abs_err": worst}


def assert_codes(got, want, ctx) -> int:
    """The bucketize contract: >= 99.99% of codes equal, every other one
    bucket off; -> the largest code difference."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{ctx}: dtype or shape differs")
    diff = (got.long() - want.long()).abs()
    share = float((diff == 0).float().mean())
    worst = int(diff.max())
    check(share >= 0.9999 and worst <= 1,
          f"{ctx}: {share:.6f} of codes equal, max difference {worst}")
    return worst


def phase_a_bucketize(gen) -> dict:
    from repro_torch.kernels.bucketize import kernel as bk_kernel
    from repro_torch.kernels.bucketize import ref as bk_ref

    rows = []
    worst = 0
    for B, n in ((131071, 400), (5001, 37), (64, 800), (3, 1)):
        x = torch.randn((B, n), generator=gen, device="cuda") * (
            0.1 + 3 * torch.rand((B, 1), generator=gen, device="cuda"))
        x[0] = 0.0
        for mode, param, dt in (("round", 100.0, torch.int8),
                                ("round", 1000.0, torch.int16),
                                ("floor", 0.1, torch.int8),
                                ("floor", 0.05, torch.int16)):
            got = bk_kernel.bucketize_cuda(x, mode, param, dt)
            torch.cuda.synchronize()
            ctx = (B, n, mode, param, str(dt))
            err = assert_codes(got, bk_ref.bucketize_ref(x, mode, param, dt),
                               ctx)
            check(bool((got[0] == 0).all()), f"{ctx}: zero row not 0")
            worst = max(worst, err)
            rows.append({"B": B, "n": n, "mode": mode, "param": param,
                         "dtype": str(dt).replace("torch.", ""),
                         "max_abs_err": err})
    return {"phase": "A", "kernel": "bucketize", "shapes": rows,
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
    from repro_torch.kernels.bucketize import ops as bk_ops
    from repro_torch.kernels.code_match import ops as cm_ops
    from repro_torch.kernels.fused_phase1 import ops as fp_ops
    from repro_torch.kernels.rerank_topk import ops as rk_ops

    fp_ops.launches = fp_ops.quant_launches = cm_ops.launches = 0
    bk_ops.launches = rk_ops.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels.bucketize import ops as bk_ops
    from repro_torch.kernels.code_match import ops as cm_ops
    from repro_torch.kernels.fused_phase1 import ops as fp_ops
    from repro_torch.kernels.rerank_topk import ops as rk_ops

    return {"fused_phase1": fp_ops.launches,
            "fused_phase1_quant": fp_ops.quant_launches,
            "code_match": cm_ops.launches, "bucketize": bk_ops.launches,
            "rerank_topk": rk_ops.launches}


def phase_c(gen) -> tuple:
    from repro_torch.core import RoundingEncoder, TrimFilter, VectorIndex
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel
    from repro_torch.kernels.fused_phase1 import ops as fp_ops
    from repro_torch.kernels.fused_phase1 import ref as fp_ref

    n_docs = N_DOCS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    raw_state = gen.get_state()        # phase D draws the raw rows again
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
                       "bound_by": by}}, index, queries, src, raw_state


def rerank_case(index, q, cand, ctx) -> dict:
    """rerank_topk.ops.rerank_topk on ``cand`` against the core path:
    ids equal except where the k-th and (k+1)-th plain scores lie within
    the kernel's tolerance, scores bit-equal where the ids are; the
    kernel's scores within rtol 1e-4 / atol 5e-5 of the plain version;
    times of the kernel, the plain version (gather + einsum) and the
    einsum alone on pre-gathered rows (device time, from a CUDA graph:
    at page 320 the wrapper's host work outlasts the kernel, so
    ``call_ms`` times the calls as a caller makes them), the gathered
    signature (``ops.rerank_scores`` over the pre-gathered rows, the
    like-for-like peer of the einsum), and the bound."""
    from repro_torch.core.rerank import rerank_topk as core_rerank
    from repro_torch.kernels.rerank_topk import kernel as rk_kernel
    from repro_torch.kernels.rerank_topk import ops as rk_ops
    from repro_torch.kernels.rerank_topk import ref as rk_ref

    ids_g, s_g = rk_ops.rerank_topk(index.vectors, cand, q, K)
    ids_c, s_c = core_rerank(index.vectors, cand, q, K)
    cand = cand.to(torch.int32).contiguous()
    plain = rk_ref.candidate_scores_ref(index.vectors, cand, q)
    got = rk_kernel.rerank_scores_cuda(index.vectors, cand, q)
    err = float((got - plain).abs().max())
    check(bool(torch.isclose(got, plain, rtol=1e-4, atol=5e-5).all()),
          f"{ctx}: kernel off the plain version by {err}")
    srt = torch.sort(plain, dim=1, descending=True).values
    apart = srt[:, K - 1] - srt[:, K] > 5e-5 + 1e-4 * srt[:, K].abs()
    check(torch.equal(ids_g[apart], ids_c[apart]),
          f"{ctx}: ids differ from core.rerank.rerank_topk away from ties")
    same = ids_g == ids_c
    check(torch.equal(s_g[same], s_c[same]),
          f"{ctx}: scores of equal ids not bit-equal")
    gathered = index.vectors[cand.long()]
    # the gathered signature against the einsum on the same rows; these
    # timing calls are not main-path launches, so the count is restored
    n_launched = rk_ops.launches
    g_err = float((rk_ops.rerank_scores(gathered, q) - plain).abs().max())
    check(g_err <= 5e-5 + 1e-4 * float(plain.abs().max()),
          f"{ctx}: gathered signature off the plain version by {g_err}")
    gathered_ms = graph_ms(lambda: rk_ops.rerank_scores(gathered, q), 20)
    rk_ops.launches = n_launched
    bound, by = rerank_bound_ms(cand, index.n_features)
    row = {"Q": cand.shape[0], "page": cand.shape[1],
           "ids_equal_share": float(same.float().mean()),
           "queries_apart": int(apart.sum()), "max_abs_err": err,
           "ms": graph_ms(lambda: rk_kernel.rerank_scores_cuda(
               index.vectors, cand, q), 20),
           "call_ms": cuda_ms(lambda: rk_kernel.rerank_scores_cuda(
               index.vectors, cand, q), 20),
           "plain_ms": graph_ms(lambda: rk_ref.candidate_scores_ref(
               index.vectors, cand, q), 5),
           "library_ms": graph_ms(lambda: torch.einsum(
               "qpn,qn->qp", gathered, q), 5),
           "gathered_ms": gathered_ms, "gathered_max_abs_err": g_err,
           "bound_ms": bound, "bound_by": by}
    del gathered
    return row


def phase_d(gen, index, queries, src, raw_state) -> tuple:
    """Every other engine on phase C's index, then bucketize at full size
    and rerank_topk on the served candidates; -> (summary line, the
    ``kernels`` entries of code_match, fused_phase1_quant, bucketize and
    rerank_topk)."""
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

    # index.search with no engine named: postings, exact; served twice,
    # and its phase-1 scores taken twice: each pair bit-equal
    qs = torch.from_numpy(queries[:BATCH])
    lat, answers = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        t = time.monotonic()
        answers.append(index.search(qs, k=K, page=PAGE,
                                    trim=TrimFilter(0.05)))
        torch.cuda.synchronize()
        lat.append(time.monotonic() - t)
        progress(f"postings: batch served in {lat[-1]:.3f} s")
    ids, scores = answers[-1]
    served_equal = all(torch.equal(a, b) for a, b in zip(*answers))
    check(served_equal, "postings: two servings differ")
    _, qcodes, w = index.encode_queries(qs.cuda(), TrimFilter(0.05), None,
                                        "idf")
    first = index.phase1_scores(qcodes, w, "postings", None)
    scores_equal = torch.equal(first,
                               index.phase1_scores(qcodes, w, "postings",
                                                   None))
    check(scores_equal, "postings: two runs of phase-1 scores differ")
    del first, answers
    row = {"engine": "postings", "engine_named": False, "queries": BATCH,
           "batch_latency_s": lat, "batch_latency_s_median": lat[-1],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "runs_bit_equal": {"served": served_equal,
                              "phase1_scores": scores_equal},
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

    # the kernels alone at Q 32 on the served index
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
                                         PAGE + 1)
    qn_err = assert_quant_parity(got, want, index.n_docs, "quant served "
                                 "shape")
    qn_plain_ms = host_ms(lambda: fp_ref.fused_phase1_quant_ref(
        qt.codes, qt.scale, qt.zero, q, PAGE))
    qn_ms = cuda_ms(lambda: fp_kernel.fused_phase1_quant_cuda(
        qt.codes, qt.scale, qt.zero, q, PAGE), 3)
    qn_bound, qn_by = quant_bound_ms(index.n_docs, BATCH, N_FEATURES, PAGE,
                                     False)
    # bucketize at full size: the raw rows phase C's index was built from
    from repro_torch.core.rerank import normalize
    from repro_torch.kernels.bucketize import kernel as bk_kernel
    from repro_torch.kernels.bucketize import ops as bk_ops
    from repro_torch.kernels.bucketize import ref as bk_ref
    from repro_torch.kernels.fused_phase1 import ops as fp_ops
    from repro_torch.kernels.rerank_topk import ops as rk_ops

    g = torch.Generator(device="cuda")
    g.set_state(raw_state)
    raw = torch.randn((index.n_docs, N_FEATURES), generator=g, device="cuda")
    check(torch.equal(normalize(raw[:65536]), index.vectors[:65536]),
          "raw rows drawn again differ from the index's")
    reset_launches()
    codes = bk_ops.encode(raw, index.encoder)
    torch.cuda.synchronize()
    bk_launches = read_launches()["bucketize"]
    check(bk_launches == bk_kernel.KERNELS_PER_CALL,
          f"bucketize launched {bk_launches} CUDA kernels, want 1")
    bk_err = assert_codes(codes, index.codes, "bucketize 4,181,504 rows")
    bk_differ = int((codes != index.codes).sum())
    del codes
    scale = float(index.encoder.scale)
    dt = index.codes.dtype
    bk_ms = cuda_ms(lambda: bk_kernel.bucketize_cuda(raw, "round", scale,
                                                     dt), 5)

    def bk_plain():
        for lo in range(0, raw.shape[0], 1 << 18):
            bk_ref.bucketize_ref(raw[lo:lo + (1 << 18)], "round", scale, dt)

    bk_plain_ms = cuda_ms(bk_plain, 2)
    bk_bound, bk_by = bucketize_bound_ms(index.n_docs, N_FEATURES,
                                         index.codes.element_size())
    del raw
    bucketize = {"B": index.n_docs, "n": N_FEATURES, "launches": bk_launches,
                 "codes_differing": bk_differ, "max_abs_err": bk_err,
                 "ms": bk_ms, "plain_ms": bk_plain_ms, "bound_ms": bk_bound,
                 "bound_by": bk_by, "library_ms": None}
    emit({"phase": "D", "kernel": "bucketize", **bucketize})

    # rerank_topk on the served candidates (page 320) and at page 8192
    reset_launches()
    _, cand = fp_ops.fused_phase1(index.codes, qcodes, w, PAGE)
    served = rerank_case(index, q, cand, "rerank page 320")
    rk_launches = read_launches()["rerank_topk"]
    check(rk_launches >= 1, "rerank_topk launched no CUDA kernel")
    _, cand = fp_kernel.fused_phase1_cuda(index.codes, qcodes, w, 8192)
    wide = rerank_case(index, q, cand, "rerank page 8192")
    del cand
    rerank = {**served, "launches": rk_launches, "page_8192": wide}
    emit({"phase": "D", "kernel": "rerank_topk", **rerank})

    kernels = {
        "bucketize": bucketize,
        "rerank_topk": rerank,
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


def quality(ids, sims, gold_ids, gold_sims) -> dict:
    from repro_torch.core import avg_diff, ndcg_k, precision_at_k

    return {"p_at_10": float(precision_at_k(ids, gold_ids).mean()),
            "ndcg": float(ndcg_k(sims, gold_sims).mean()),
            "avg_diff": float(avg_diff(sims, gold_sims).mean())}


def phase_e() -> tuple:
    """The paper's quality path on the card; -> (the phase line, the
    bucketize and rerank_topk launches of its run)."""
    from repro_torch.core import (CombinedEncoder, IntervalEncoder, MLTIndex,
                                  RoundingEncoder, TrimFilter, VectorIndex,
                                  avg_diff, precision_at_k)
    from repro_torch.data import make_corpus
    from repro_torch.kernels.bucketize import ops as bk_ops
    from repro_torch.kernels.fused_phase1 import ops as fp_ops
    from repro_torch.lsa import build_lsa

    torch.cuda.reset_peak_memory_stats()
    t = t_phase = time.monotonic()
    corpus = make_corpus(n_docs=E_DOCS, vocab_size=E_VOCAB,
                         n_topics=E_TOPICS, seed=0)
    corpus_s = time.monotonic() - t
    progress(f"corpus of {E_DOCS} docs made in {corpus_s:.1f} s")
    reset_launches()
    lsa_s, vecs = [], []
    for _ in range(2):             # built twice: the same bits each time
        t = time.monotonic()
        vecs.append(build_lsa(corpus, n_features=N_FEATURES,
                              device="cuda").doc_vectors)
        torch.cuda.synchronize()
        lsa_s.append(time.monotonic() - t)
        progress(f"LSA built in {lsa_s[-1]:.1f} s")
    lsa_equal = torch.equal(vecs[0], vecs[1])
    check(lsa_equal, "two LSA builds differ")
    vecs = vecs[0]
    check(vecs.shape == (E_DOCS, N_FEATURES)
          and bool(torch.isfinite(vecs).all()), "LSA vectors not finite")
    encoder = CombinedEncoder(RoundingEncoder(1), IntervalEncoder(0.1))
    t = time.monotonic()
    index = VectorIndex.build(vecs, encoder=encoder, device="cuda")
    torch.cuda.synchronize()
    build_s = time.monotonic() - t
    codes = bk_ops.encode(vecs, encoder)
    codes_shape = list(codes.shape)
    n = N_FEATURES
    code_err = max(assert_codes(codes[:, :n], index.codes[:, :n],
                                "LSA rounding codes"),
                   assert_codes(codes[:, n:], index.codes[:, n:],
                                "LSA interval codes"))
    code_differ = int((codes != index.codes).sum())
    del codes

    Q = vecs[:E_QUERIES]
    gold_ids, gold_sims = index.gold_topk(Q, K)
    trim = TrimFilter(0.05)
    out = {}
    for engine in ("codes", "fused"):
        ids, sims = index.search(Q, k=K, page=PAGE, trim=trim, engine=engine)
        out[engine] = quality(ids, sims, gold_ids, gold_sims)
    t = time.monotonic()
    mlt = MLTIndex.build(corpus.doc_terms, corpus.doc_tf, corpus.vocab_size,
                         device="cuda")
    torch.cuda.synchronize()
    mlt_build_s = time.monotonic() - t
    ids_m, s_m = mlt.more_like_this(corpus.doc_terms[:E_QUERIES],
                                    corpus.doc_tf[:E_QUERIES],
                                    max_query_terms=25, k=K)
    mlt_runs = [mlt.scores(corpus.doc_terms[:E_QUERIES],
                           corpus.doc_tf[:E_QUERIES], max_query_terms=25)
                for _ in range(2)]
    mlt_equal = (torch.equal(mlt_runs[0], mlt_runs[1])
                 and torch.equal(s_m, torch.gather(mlt_runs[0], 1,
                                                   ids_m.long())))
    check(mlt_equal, "two runs of the MLT scores differ")
    del mlt_runs
    sims_m = torch.gather(Q @ index.vectors.T, 1, ids_m.long())
    out["mlt"] = quality(ids_m, sims_m, gold_ids, gold_sims)
    del mlt
    progress(f"quality {out}")

    # C1: avg.diff does not rise with page
    c1 = []
    for page in (20, 80, 320, 640):
        _, sims = index.search(Q, k=K, page=page, trim=trim, engine="codes")
        c1.append(float(avg_diff(sims, gold_sims).mean()))
    check(all(a >= b - 1e-6 for a, b in zip(c1, c1[1:])) and c1[0] > c1[-1],
          f"C1: avg.diff over pages 20, 80, 320, 640 is {c1}")
    # C2: trim 0.05 within 0.08 P@10 of unfiltered
    ids_u, sims_u = index.search(Q, k=K, page=PAGE, engine="codes")
    unfiltered = quality(ids_u, sims_u, gold_ids, gold_sims)
    check(out["codes"]["p_at_10"] >= unfiltered["p_at_10"] - 0.08,
          f"C2: P@10 trim 0.05 {out['codes']['p_at_10']} vs unfiltered "
          f"{unfiltered['p_at_10']}")
    # C3: the method beats MLT on all three metrics
    for engine in ("codes", "fused"):
        o, m = out[engine], out["mlt"]
        check(o["p_at_10"] > m["p_at_10"] and o["ndcg"] > m["ndcg"]
              and o["avg_diff"] < m["avg_diff"],
              f"C3: {engine} {o} does not beat MLT {m}")
    # C4: page = n_docs is brute force
    ids4, _ = index.search(Q[:E_EXACT_QUERIES], k=K, page=index.n_docs,
                           engine="codes")
    check(torch.equal(ids4, gold_ids[:E_EXACT_QUERIES]),
          "C4: page = n_docs differs from brute force")
    # C5: query-side filtering leaves the index's codes as they were
    before = index.codes.clone()
    p5 = []
    for f in (None, TrimFilter(0.05), TrimFilter(0.2)):
        ids, _ = index.search(Q, k=K, page=160, trim=f, engine="codes")
        p5.append(float(precision_at_k(ids, gold_ids).mean()))
    check(torch.equal(index.codes, before) and p5[0] >= p5[2] - 1e-6,
          f"C5: codes changed or P@10 {p5}")
    del before

    # rerank_topk on the fused candidates, held to the core path
    q, qcodes, w = index.encode_queries(Q, trim, None, "idf")
    _, cand = fp_ops.fused_phase1(index.codes, qcodes, w, PAGE)
    rerank = rerank_case(index, q, cand, "phase E rerank")
    got = read_launches()
    check(got["bucketize"] == 2 and got["rerank_topk"] >= 1
          and got["fused_phase1"] >= 4,
          f"phase E launches {got}")
    line = {"phase": "E", "n_docs": E_DOCS, "vocab_size": E_VOCAB,
            "n_topics": E_TOPICS, "n_features": N_FEATURES,
            "queries": E_QUERIES,
            "cut": f"{E_DOCS} docs of English Wikipedia's 4,181,352: the "
                   f"corpus generator's per-doc host loop",
            "encoder": encoder.scheme_id, "page": PAGE, "trim": 0.05,
            "quality": out, "unfiltered_codes": unfiltered,
            "c1_avg_diff_by_page": dict(zip((20, 80, 320, 640), c1)),
            "c5_p_at_10_none_t005_t02": p5,
            "bucketize": {"codes": codes_shape,
                          "codes_differing": code_differ,
                          "max_abs_err": code_err},
            "rerank_topk": rerank, "launches": got,
            "runs_bit_equal": {"lsa_doc_vectors": lsa_equal,
                               "mlt_scores": mlt_equal},
            "corpus_s": corpus_s, "lsa_s": lsa_s[0],
            "lsa_s_second": lsa_s[1], "index_build_s": build_s,
            "mlt_build_s": mlt_build_s,
            "phase_s": time.monotonic() - t_phase,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    return line, got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="ABCDE")
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
    from repro_torch.kernels.bucketize import kernel as bk_kernel
    from repro_torch.kernels.code_match import kernel as cm_kernel
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel
    from repro_torch.kernels.rerank_topk import kernel as rk_kernel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t = time.monotonic()
    builds = {"fused_phase1": fp_kernel.library,
              "fused_phase1_quant": fp_kernel.quant_library,
              "code_match": cm_kernel.library,
              "bucketize": bk_kernel.library,
              "rerank_topk": rk_kernel.library}
    with ThreadPoolExecutor(len(builds)) as pool:   # one nvcc each, at once
        for f in [pool.submit(fn) for fn in builds.values()]:
            f.result()
    build_s = time.monotonic() - t
    ptxas = {}
    frames = {}
    for name in builds:
        log = _build.build_dir() / f"{name}.log"
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln for ln in lines
                       if "registers" in ln or "spill" in ln]
        frames[name] = stack_frames(lines)
    emit({"device": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas,
          "stack_frames": frames})
    for name, kernel in (("fused_phase1", "score_fold_kernel"),
                         ("code_match", "code_match_kernel")):
        scorers = {fn: b for fn, b in frames[name].items() if kernel in fn}
        check(len(scorers) == 3 and not any(scorers.values()),
              f"{name}: scorer kernels' stack frames {scorers}, want 0")

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = c = None
    a_err = {}
    kd = {}
    e_launches = {}
    if "A" in args.phases:
        a = phase_a(gen)
        emit(a)
        for line in (phase_a_code_match(gen), phase_a_quant(gen),
                     phase_a_rerank(gen), phase_a_bucketize(gen)):
            emit(line)
            a_err[line["kernel"]] = line["max_abs_err"]
    if "B" in args.phases:
        emit(phase_b())
    if "C" in args.phases:
        c, index, queries, src, raw_state = phase_c(gen)
        emit(c)
        if "D" in args.phases:
            summary, kd = phase_d(gen, index, queries, src, raw_state)
            emit(summary)
        del index
        torch.cuda.empty_cache()
    if "E" in args.phases:
        line, e_launches = phase_e()
        emit(line)
        for name in ("bucketize", "rerank_topk"):
            a_err[name] = max(a_err.get(name, 0.0),
                              line[name]["max_abs_err"])
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
    entries[0]["stack_frame_bytes"] = max(frames["fused_phase1"].values(),
                                          default=None)
    for name, source, replaces in (
            ("code_match",
             "src/repro_torch/kernels/code_match/csrc/code_match.cu",
             "src/repro/kernels/code_match/kernel.py:49"),
            ("fused_phase1_quant",
             "src/repro_torch/kernels/fused_phase1/csrc/"
             "fused_phase1_quant.cu",
             "src/repro/kernels/fused_phase1/kernel.py:154"),
            ("rerank_topk",
             "src/repro_torch/kernels/rerank_topk/csrc/rerank_topk.cu",
             "src/repro/kernels/rerank_topk/kernel.py:31"),
            ("bucketize",
             "src/repro_torch/kernels/bucketize/csrc/bucketize.cu",
             "src/repro/kernels/bucketize/kernel.py:38")):
        k = kd.get(name, {})
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": k.get("launches", 0) + e_launches.get(name, 0),
            "max_abs_err": max(a_err.get(name, 0.0),
                               k.get("max_abs_err", 0.0)),
            "ms": k.get("ms"), "plain_ms": k.get("plain_ms"),
            "bound_ms": k.get("bound_ms"), "bound_by": k.get("bound_by"),
            "library_ms": k.get("library_ms"),
            "stack_frame_bytes": max(frames[name].values(), default=None)})
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
