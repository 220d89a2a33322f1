#!/usr/bin/env python3
"""Where ``rerank_topk``'s time goes on the card: throw-away variants of
the one-block-per-32-candidates body, and the host cost of one call.

    python3 tools/rerank_study.py variants   # page 8192 and 320, Q 32
    python3 tools/rerank_study.py call       # call_ms at page 320, Q 32
    python3 tools/rerank_study.py sweep      # the bulk body's ring shapes

``variants`` builds a library of its own (never used by the package)
holding three copies of the original one-block-per-32-candidates body of
``src/repro_torch/kernels/rerank_topk/csrc/rerank_topk.cu``: ``base``
(as it is), ``unroll400`` (its ``k`` loop unrolled to a compile-time
n = 400, so one step's loads overlap the previous step's FMAs) and
``cand16`` (16 candidates a warp, 16 rows' loads in flight).  On a
4,181,504 x 400 table of seeded unit rows and 32 queries with 8,192
random candidate ids each (the shape of phase D in ``chip_smoke.py``),
it times, in turns (einsum, then each kernel, three rounds), each
variant, the package's kernel by id (every body it has), and
``torch.einsum`` on the same rows pre-gathered, all from CUDA graphs of
20 launches; at page 320 the same, warm (one candidate set) only.  Each
variant is held to the plain gather + einsum (rtol 1e-4 / atol 5e-5).

``call`` times one Python call of the package's
``kernel.rerank_scores_cuda`` at page 320 as a caller makes it (CUDA
events around 200 calls, host included), so running it once with the
parent's ``src`` on ``PYTHONPATH`` and once with this tree's compares the
two launch paths on one card.

``sweep`` times the package's bulk body at other (rows a stage, stages,
blocks) than its plan picks, and copies of its source with one change
each (row copies without the L2 evict-first hint; that and 16 rows a
stage at most, the body as first built; 8 consumer warps), beside the
einsum and the simple body: page 8192,
and page 320 over 8 random candidate sets rotated in one graph (131 MB
of rows, so each set is cold in the 50 MB L2).

Prints one JSON object, after the card's name and power limit.  Needs a
CUDA card; imports no JAX.
"""

from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import graph_ms  # noqa: E402  (the repo root's script)

VARIANTS_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kN4 > 0: the k loop's bound is the compile-time n / 4.
template <int kCandPerWarp, int kN4>
__global__ void __launch_bounds__(kThreads)
variant_kernel(const float* __restrict__ table, const int* __restrict__ ids,
               const float* __restrict__ queries, int d, int P, int n,
               int p_blocks, float* __restrict__ out) {
  constexpr int kCandPerBlock = (kThreads / 32) * kCandPerWarp;
  extern __shared__ __align__(16) float s_q[];
  const int q = blockIdx.x / p_blocks;
  const int pb = blockIdx.x - q * p_blocks;
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    s_q[j] = queries[(size_t)q * n + j];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int p0 = pb * kCandPerBlock + (threadIdx.x >> 5) * kCandPerWarp;
  const float* rows[kCandPerWarp];
  float acc[kCandPerWarp];
#pragma unroll
  for (int c = 0; c < kCandPerWarp; ++c) {
    const int p = min(p0 + c, P - 1);
    const int id = min(max(ids[(size_t)q * P + p], 0), d - 1);
    rows[c] = table + (size_t)id * n;
    acc[c] = 0.0f;
  }
  const float4* q4 = reinterpret_cast<const float4*>(s_q);
  if (kN4 > 0) {
#pragma unroll
    for (int j = 0; j < (kN4 + 31) / 32; ++j) {
      const int k = lane + 32 * j;
      if (k < kN4) {
        const float4 b = q4[k];
#pragma unroll
        for (int c = 0; c < kCandPerWarp; ++c) {
          const float4 a = reinterpret_cast<const float4*>(rows[c])[k];
          acc[c] = fmaf(a.x, b.x, acc[c]);
          acc[c] = fmaf(a.y, b.y, acc[c]);
          acc[c] = fmaf(a.z, b.z, acc[c]);
          acc[c] = fmaf(a.w, b.w, acc[c]);
        }
      }
    }
  } else {
    for (int k = lane; k < (n >> 2); k += 32) {
      const float4 b = q4[k];
#pragma unroll
      for (int c = 0; c < kCandPerWarp; ++c) {
        const float4 a = reinterpret_cast<const float4*>(rows[c])[k];
        acc[c] = fmaf(a.x, b.x, acc[c]);
        acc[c] = fmaf(a.y, b.y, acc[c]);
        acc[c] = fmaf(a.z, b.z, acc[c]);
        acc[c] = fmaf(a.w, b.w, acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kCandPerWarp; ++c) {
    const float s = warp_sum(acc[c]);
    if (lane == 0 && p0 + c < P) out[(size_t)q * P + p0 + c] = s;
  }
}

template <int kCandPerWarp, int kN4>
int launch(const void* table, const void* ids, const void* queries, int d,
           int Q, int P, int n, void* out, void* stream) {
  constexpr int kCandPerBlock = (kThreads / 32) * kCandPerWarp;
  const int p_blocks = (P + kCandPerBlock - 1) / kCandPerBlock;
  variant_kernel<kCandPerWarp, kN4>
      <<<p_blocks * Q, kThreads, n * 4,
         reinterpret_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(table), static_cast<const int*>(ids),
          static_cast<const float*>(queries), d, P, n, p_blocks,
          static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// variant 0: base, 1: unroll400 (n must be 400), 2: cand16
extern "C" int variant_scores(int variant, const void* table,
                              const void* ids, const void* queries, int d,
                              int Q, int P, int n, void* out, void* stream) {
  if (n % 4 != 0 || (variant == 1 && n != 400))
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0: return launch<4, 0>(table, ids, queries, d, Q, P, n, out, stream);
    case 1: return launch<4, 100>(table, ids, queries, d, Q, P, n, out,
                                  stream);
    case 2: return launch<16, 0>(table, ids, queries, d, Q, P, n, out,
                                 stream);
  }
  return (int)cudaErrorInvalidValue;
}
"""

VARIANTS = ("base", "unroll400", "cand16")
N_DOCS = 4_181_504
N_FEATURES = 400
BATCH = 32


def variants_library():
    import ctypes

    from repro_torch.kernels import _build

    src = _build.build_dir() / "rerank_study" / "variants.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(VARIANTS_CU)
    lib = _build.load_library("rerank_study_variants", [src])
    lib.variant_scores.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                   + [ctypes.c_int] * 4
                                   + [ctypes.c_void_p] * 2)
    lib.variant_scores.restype = ctypes.c_int
    log = _build.build_dir() / "rerank_study_variants.log"
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    return lib, ptxas


def run_variants() -> dict:
    from repro_torch.kernels.rerank_topk import kernel as rk_kernel

    lib, ptxas = variants_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    V = torch.randn((N_DOCS, N_FEATURES), generator=gen, device="cuda")
    V /= V.norm(dim=1, keepdim=True)
    q = torch.randn((BATCH, N_FEATURES), generator=gen, device="cuda")
    q /= q.norm(dim=1, keepdim=True)
    bodies = getattr(rk_kernel, "BODIES", (None,))
    out = {"ptxas": ptxas}
    for page in (8192, 320):
        ids = torch.randint(0, N_DOCS, (BATCH, page), generator=gen,
                            device="cuda", dtype=torch.int32)
        gathered = V[ids.long()]
        want = torch.einsum("qpn,qn->qp", gathered, q)
        res = torch.empty_like(want)

        def variant(i):
            def fn():
                err = lib.variant_scores(
                    i, V.data_ptr(), ids.data_ptr(), q.data_ptr(), N_DOCS,
                    BATCH, page, N_FEATURES, res.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
            return fn

        def package(body):
            kw = {} if body is None else {"body": body}
            return lambda: rk_kernel.rerank_scores_cuda(V, ids, q, **kw)

        fns = {"einsum": lambda: torch.einsum("qpn,qn->qp", gathered, q)}
        for i, name in enumerate(VARIANTS):
            fns[name] = variant(i)
        for body in bodies:
            fns[f"package_{body or 'default'}"] = package(body)
        errs = {}
        for name, fn in fns.items():
            got = fn()
            got = res if got is None else got
            torch.cuda.synchronize()
            errs[name] = float((got - want).abs().max())
            assert torch.isclose(got, want, rtol=1e-4, atol=5e-5).all(), \
                (name, errs[name])
        times = {name: [] for name in fns}
        for _ in range(3):
            for name in ("einsum", *[k for k in fns if k != "einsum"]):
                times[name].append(graph_ms(fns[name], 20))
        rows = int(torch.unique(ids).numel())
        bound = (rows * N_FEATURES * 4 + 2 * BATCH * page * 4
                 + BATCH * N_FEATURES * 4) / 3.35e12 * 1e3
        out[f"page_{page}"] = {
            "ms": times, "median_ms": {k: statistics.median(v)
                                       for k, v in times.items()},
            "bound_ms": bound, "max_abs_err": errs}
        del gathered
    return out


# copies of the package's source with one change each: (pattern, text)
SOURCE_VARIANTS = {
    "no_evict": [(r"full \+ stage, policy\);", "full + stage);")],
    "cw8": [(r"kConsumerWarps = 4;", "kConsumerWarps = 8;")],
}
SOURCE_VARIANTS["first"] = SOURCE_VARIANTS["no_evict"] + [
    (r"kMaxRows = 32;", "kMaxRows = 16;")]   # the bulk body as first built

# (library, rows a stage, stages, blocks) of the bulk body, n = 400; the
# package's plan is ("package", 24, 2, 264)
SWEEP = (("first", 16, 4, 264), ("first", 16, 2, 396),
         ("no_evict", 16, 2, 396), ("no_evict", 24, 2, 264),
         ("no_evict", 32, 2, 264), ("package", 8, 4, 528),
         ("package", 16, 4, 264), ("package", 16, 2, 396),
         ("package", 16, 2, 528), ("package", 24, 2, 264),
         ("package", 25, 2, 264), ("package", 32, 2, 264),
         ("package", 25, 4, 132), ("cw8", 16, 2, 396), ("cw8", 25, 2, 264))


def bulk_libraries() -> dict:
    """The package's rerank library and the SOURCE_VARIANTS copies of its
    source, bound for raw bulk launches with the dynamic shared memory
    limit raised to the card's opt-in."""
    import ctypes
    import re
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    from repro_torch.kernels.rerank_topk import kernel as rk_kernel

    src = rk_kernel._SOURCES[0].read_text()

    def build(name):
        text = src
        for pattern, repl in SOURCE_VARIANTS[name]:
            text, k = re.subn(pattern, lambda _: repl, text, count=1,
                              flags=re.S)
            assert k == 1, (name, pattern)
        path = _build.build_dir() / "rerank_study" / f"{name}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        return _build.load_library(f"rerank_study_{name}", [path])

    with ThreadPoolExecutor(len(SOURCE_VARIANTS)) as pool:
        libs = dict(zip(SOURCE_VARIANTS, pool.map(build, SOURCE_VARIANTS)))
    libs["package"] = rk_kernel.library()
    optin = _build.smem_optin(torch.cuda.get_device_properties(0))
    for lib in libs.values():
        lib.rerank_scores_bulk.argtypes = ([ctypes.c_void_p] * 3
                                           + [ctypes.c_int] * 8
                                           + [ctypes.c_void_p] * 2)
        lib.rerank_configure.argtypes = [ctypes.c_int, ctypes.c_int]
        assert lib.rerank_configure(0, optin) == 0
    return libs


def run_sweep() -> dict:
    """The bulk body at other ring shapes, grids and source variants
    (SWEEP) beside the einsum and the simple body: page 8192 (three
    alternations) and page 320 over 8 cold candidate sets rotated in one
    graph."""
    from repro_torch.kernels.rerank_topk import kernel as rk_kernel

    libs = bulk_libraries()
    gen = torch.Generator(device="cuda").manual_seed(0)
    V = torch.randn((N_DOCS, N_FEATURES), generator=gen, device="cuda")
    V /= V.norm(dim=1, keepdim=True)
    q = torch.randn((BATCH, N_FEATURES), generator=gen, device="cuda")
    q /= q.norm(dim=1, keepdim=True)
    out = {}
    for page, n_sets in ((8192, 1), (320, 8)):
        sets = [torch.randint(0, N_DOCS, (BATCH, page), generator=gen,
                              device="cuda", dtype=torch.int32)
                for _ in range(n_sets)]
        gathered = [V[s.long()] for s in sets]
        res = torch.empty((BATCH, page), device="cuda")

        def bulk(lib, rows, stages, blocks):
            smem = rk_kernel.bulk_smem_bytes(N_FEATURES, rows, stages)
            blocks = min(blocks, BATCH * -(-page // rows))

            def fn():
                for s in sets:
                    err = lib.rerank_scores_bulk(
                        V.data_ptr(), s.data_ptr(), q.data_ptr(), N_DOCS,
                        BATCH, page, N_FEATURES, rows, stages, blocks, smem,
                        res.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                    assert err == 0, err
            return fn

        fns = {"einsum": lambda: [torch.einsum("qpn,qn->qp", g, q)
                                  for g in gathered],
               "simple": lambda: [rk_kernel.rerank_scores_cuda(
                   V, s, q, body="simple") for s in sets]}
        for lib, *cfg in SWEEP:
            fns["%s_%d_%d_%d" % (lib, *cfg)] = bulk(libs[lib], *cfg)
        want = torch.einsum("qpn,qn->qp", gathered[-1], q)
        for name, fn in fns.items():
            if name not in ("einsum", "simple"):
                fn()
                torch.cuda.synchronize()
                assert torch.isclose(res, want, rtol=1e-4,
                                     atol=5e-5).all(), name
        times = {name: [] for name in fns}
        for r in range(3):
            for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                times[name].append(graph_ms(fns[name], 20 // n_sets or 1)
                                   / n_sets)
        out[f"page_{page}"] = {
            "sets": n_sets, "ms": times,
            "median_ms": {k: statistics.median(v) for k, v in times.items()}}
        del gathered
    return out


def run_call() -> dict:
    from repro_torch.kernels.rerank_topk import kernel as rk_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    V = torch.randn((131072, N_FEATURES), generator=gen, device="cuda")
    q = torch.randn((BATCH, N_FEATURES), generator=gen, device="cuda")
    ids = torch.randint(0, 131072, (BATCH, 320), generator=gen,
                        device="cuda", dtype=torch.int32)
    samples = []
    for _ in range(5):
        for _ in range(20):
            rk_kernel.rerank_scores_cuda(V, ids, q)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(200):
            rk_kernel.rerank_scores_cuda(V, ids, q)
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / 200)
    return {"call_ms": samples, "call_ms_median": statistics.median(samples),
            "package": str(pathlib.Path(rk_kernel.__file__).resolve())}


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 else "variants"
    if mode not in ("variants", "call", "sweep"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("rerank_study: no CUDA device", file=sys.stderr)
        return 1
    if "PYTHONPATH" not in os.environ:     # else the caller names the tree
        sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                               / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    res = {"variants": run_variants, "call": run_call,
           "sweep": run_sweep}[mode]()
    print(json.dumps({"mode": mode, "device": smi, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
