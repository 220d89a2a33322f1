// Fused phase-1 search kernel for Hopper (sm_90a): weighted code-match
// scoring plus a running stable top-`page`, without a (Q, d) score matrix.
//
// Replaces: src/repro/kernels/fused_phase1/kernel.py::fused_phase1_pallas
// (body _fused_kernel, fold _fold_topk).  The TPU kernel walks the doc
// tiles IN ORDER on one core and keeps a (BLOCK_Q, page) accumulator in a
// revisited output block.  Blocks on Hopper run in no order, so:
//
//   pass 1 (score_fold_kernel): grid (query tiles, doc splits).  A block
//     owns BLOCK_Q queries (codes and weights in shared memory) and one
//     contiguous doc split, which it walks tile by tile INSIDE the block.
//     Each tile of TILE docs is scored into shared memory (-inf for dead
//     docs), bitonic-sorted, and merged into the block's running top-P2
//     accumulator (P2 = next_pow2(page)).  The accumulator goes out as one
//     sorted partial list per (query, split).
//   pass 2 (merge_splits_kernel): one block per query merges the split
//     lists into the final top-`page`, ids clamped to [0, d).
//
// Entries are ordered by (score descending, id ascending), a total order,
// so every fold is a selection under one order and the result equals one
// global stable top-k -- the same as jax.lax.top_k's lower-index-wins --
// whatever the split count or tile width.  No atomics: the result does
// not depend on scheduling.
//
// Bit-exact scores.  The reference sums the C selected weights with a
// pairwise tree over C zero-padded to PC = next_pow2(C): x[i] + x[i+PC/2],
// repeated.  That tree is an adjacent-pair tree over the columns taken in
// BIT-REVERSED order, so one thread folds a (query, doc) cell by walking
// t = 0..PC-1, taking leaf c = bitrev(t) (w[q,c] on a code match, else
// +0.0, and +0.0 for c >= C), and merging partial sums on a stack like a
// binary counter.  Only fp32 adds, in the reference's order.  Build
// without --use_fast_math: nothing may be flushed to zero.
//
// What bounds it on the H100: it reads the d*C code bytes once per query
// tile, and does Q*d*C compare-select-adds on the CUDA cores -- equality
// has no tensor-core form -- so it is bound by operations, not bytes.
//
// What this simple design leaves for later: the code rows are staged in
// shared memory by plain synchronous loads (no cp.async or TMA pipeline);
// the tree stack lives in local memory; every doc tile is sorted and
// merged, with no skip of tiles whose best score cannot enter the
// accumulator; tiles are scored with no overlap of loads and compute.
//
// Limits: page <= 1024 (P2 <= kMaxPage), C <= 4096 (stack depth), and the
// shared memory the wrapper computes must fit the card's opt-in maximum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxLogC = 12;     // C <= 4096
constexpr int kMaxPage = 1024;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  // true when entry a ranks ahead of entry b
  return sa > sb || (sa == sb && ia < ib);
}

// Bitonic sort of `nseg` segments of `n` entries (n a power of two), each
// into best-first order.  All threads of the block take part.
__device__ void sort_segments(float* s, int* id, int nseg, int n) {
  const int half = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int e = threadIdx.x; e < nseg * half; e += blockDim.x) {
        const int seg = e / half, p = e % half;
        const int i = 2 * j * (p / j) + (p % j);
        const int a = seg * n + i, b = a + j;
        const bool up = (i & k) == 0;
        const bool swap = up ? before(s[b], id[b], s[a], id[a])
                             : before(s[a], id[a], s[b], id[b]);
        if (swap) {
          const float ts = s[a]; s[a] = s[b]; s[b] = ts;
          const int ti = id[a]; id[a] = id[b]; id[b] = ti;
        }
      }
      __syncthreads();
    }
  }
}

// acc (nseg x n, each best-first) <- best n of acc U src, best-first.
// src segments are best-first with stride `src_stride` and at least n
// entries.  acc[i] vs src[n-1-i] keeps the better of each pair: the n
// best of the union, as a bitonic sequence; a half-cleaner cascade then
// sorts it.
__device__ void merge_into(float* acc_s, int* acc_i, const float* src_s,
                           const int* src_i, int nseg, int n,
                           int src_stride) {
  for (int e = threadIdx.x; e < nseg * n; e += blockDim.x) {
    const int seg = e / n, i = e % n;
    const int a = seg * n + i, b = seg * src_stride + (n - 1 - i);
    if (before(src_s[b], src_i[b], acc_s[a], acc_i[a])) {
      acc_s[a] = src_s[b];
      acc_i[a] = src_i[b];
    }
  }
  __syncthreads();
  const int half = n >> 1;
  for (int j = half; j > 0; j >>= 1) {
    for (int e = threadIdx.x; e < nseg * half; e += blockDim.x) {
      const int seg = e / half, p = e % half;
      const int i = 2 * j * (p / j) + (p % j);
      const int a = seg * n + i, b = a + j;
      if (before(acc_s[b], acc_i[b], acc_s[a], acc_i[a])) {
        const float ts = acc_s[a]; acc_s[a] = acc_s[b]; acc_s[b] = ts;
        const int ti = acc_i[a]; acc_i[a] = acc_i[b]; acc_i[b] = ti;
      }
    }
    __syncthreads();
  }
}

// One (query, doc) cell through the reference's pairwise tree.
template <typename T>
__device__ __forceinline__ float cell_score(const T* drow, const T* qc,
                                            const float* w, int C,
                                            int log_pc) {
  float stk[kMaxLogC + 1];
  const int pc = 1 << log_pc;
  for (int t = 0; t < pc; ++t) {
    const int c = log_pc ? (int)(__brev((unsigned)t) >> (32 - log_pc)) : 0;
    float v = 0.0f;
    if (c < C && qc[c] == drow[c]) v = w[c];
    int lvl = 0;
    while ((t >> lvl) & 1) {
      v = stk[lvl] + v;
      ++lvl;
    }
    stk[lvl] = v;
  }
  return stk[log_pc];
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of score_fold_kernel's shared memory: the one layout the
// kernel addresses and the wrapper sizes its launch by.
struct FoldLayout {
  size_t acc_s, acc_i, til_s, til_i, w, qc, codes, total;
};

__host__ __device__ inline FoldLayout fold_layout(int esize, int block_q,
                                                  int pp, int tile, int C,
                                                  int sub, int stride) {
  FoldLayout L;
  size_t o = 0;
  L.acc_s = o; o += (size_t)block_q * pp * 4;
  L.acc_i = o; o += (size_t)block_q * pp * 4;
  L.til_s = o; o += (size_t)block_q * tile * 4;
  L.til_i = o; o += (size_t)block_q * tile * 4;
  L.w = o;     o = align16(o + (size_t)block_q * C * 4);
  L.qc = o;    o = align16(o + (size_t)block_q * C * esize);
  L.codes = o; o = align16(o + (size_t)sub * stride * esize);
  L.total = o;
  return L;
}

// Pass 1.  Per doc tile: the code rows are staged `sub` rows at a time in
// shared memory (coalesced loads; row stride `stride` elements, an odd
// number of 4-byte words, so a warp reading one column of 32 rows hits 32
// banks), each thread scores (query, doc) cells of the staged rows, then
// the tile is sorted and merged into the accumulator.
template <typename T>
__global__ void __launch_bounds__(kThreads)
score_fold_kernel(const T* __restrict__ doc_codes, const T* __restrict__ qcodes,
                  const float* __restrict__ col_weights,
                  const uint8_t* __restrict__ live, int d, int C, int Q,
                  int block_q, int log_pc, int pp, int tile, int sub,
                  int stride, int chunk, int splits,
                  float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FoldLayout L =
      fold_layout(sizeof(T), block_q, pp, tile, C, sub, stride);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc_s);
  int* acc_i = reinterpret_cast<int*>(smem + L.acc_i);
  float* til_s = reinterpret_cast<float*>(smem + L.til_s);
  int* til_i = reinterpret_cast<int*>(smem + L.til_i);
  float* s_w = reinterpret_cast<float*>(smem + L.w);
  T* s_qc = reinterpret_cast<T*>(smem + L.qc);
  T* s_codes = reinterpret_cast<T*>(smem + L.codes);

  const int q0 = blockIdx.x * block_q;
  const int nq = min(block_q, Q - q0);
  const int split = blockIdx.y;

  for (int e = threadIdx.x; e < block_q * C; e += blockDim.x) {
    const int q = e / C;
    const bool ok = q < nq;
    s_qc[e] = ok ? qcodes[(size_t)(q0 + q) * C + (e % C)] : T(0);
    s_w[e] = ok ? col_weights[(size_t)(q0 + q) * C + (e % C)] : 0.0f;
  }
  for (int e = threadIdx.x; e < block_q * pp; e += blockDim.x) {
    acc_s[e] = neg_inf();
    acc_i[e] = 0;
  }
  __syncthreads();

  const int d_lo = split * chunk;
  const int d_hi = min(d_lo + chunk, d);
  for (int base = d_lo; base < d_hi; base += tile) {
    for (int s0 = 0; s0 < tile; s0 += sub) {
      const int r0 = base + s0;
      const int rows = max(0, min(sub, d_hi - r0));
      for (int e = threadIdx.x; e < rows * C; e += blockDim.x)
        s_codes[(e / C) * stride + e % C] = doc_codes[(size_t)r0 * C + e];
      __syncthreads();
      for (int e = threadIdx.x; e < block_q * sub; e += blockDim.x) {
        const int q = e / sub, j = e % sub;
        const int doc = r0 + j;
        float s = neg_inf();
        if (q < nq && j < rows && (live == nullptr || live[doc])) {
          s = cell_score<T>(s_codes + j * stride, s_qc + q * C, s_w + q * C,
                            C, log_pc);
        }
        til_s[q * tile + s0 + j] = s;
        til_i[q * tile + s0 + j] = doc;
      }
      __syncthreads();
    }
    sort_segments(til_s, til_i, block_q, tile);
    merge_into(acc_s, acc_i, til_s, til_i, block_q, pp, tile);
  }

  for (int e = threadIdx.x; e < nq * pp; e += blockDim.x) {
    const int q = e / pp, i = e % pp;
    const size_t o = ((size_t)(q0 + q) * splits + split) * pp + i;
    part_s[o] = acc_s[e];
    part_i[o] = acc_i[e];
  }
}

__global__ void __launch_bounds__(kThreads)
merge_splits_kernel(const float* __restrict__ part_s,
                    const int* __restrict__ part_i, int splits, int pp,
                    int page, int d, float* __restrict__ out_s,
                    int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc_s = reinterpret_cast<float*>(smem);
  int* acc_i = reinterpret_cast<int*>(acc_s + pp);
  float* src_s = reinterpret_cast<float*>(acc_i + pp);
  int* src_i = reinterpret_cast<int*>(src_s + pp);

  const int q = blockIdx.x;
  const size_t row = (size_t)q * splits * pp;
  for (int i = threadIdx.x; i < pp; i += blockDim.x) {
    acc_s[i] = part_s[row + i];
    acc_i[i] = part_i[row + i];
  }
  for (int sp = 1; sp < splits; ++sp) {
    for (int i = threadIdx.x; i < pp; i += blockDim.x) {
      src_s[i] = part_s[row + (size_t)sp * pp + i];
      src_i[i] = part_i[row + (size_t)sp * pp + i];
    }
    __syncthreads();
    merge_into(acc_s, acc_i, src_s, src_i, 1, pp, pp);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < page; i += blockDim.x) {
    out_s[(size_t)q * page + i] = acc_s[i];
    out_i[(size_t)q * page + i] = min(acc_i[i], d - 1);
  }
}

int log2_ceil(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

template <typename T>
int launch(const void* doc_codes, const void* qcodes, const void* col_weights,
           const void* live, int d, int C, int Q, int page, int block_q,
           int tile, int sub, int stride, int chunk, int splits, void* part_s,
           void* part_i, void* out_s, void* out_i, void* stream) {
  const int log_pc = log2_ceil(C);
  const int pp = 1 << log2_ceil(page);
  if (C < 1 || C > (1 << kMaxLogC) || page < 1 || pp > kMaxPage ||
      tile < pp || (tile & (tile - 1)) || sub < 1 || (sub & (sub - 1)) ||
      sub > tile || stride < C || d < 1 || Q < 1 || block_q < 1 ||
      chunk % tile || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem1 =
      fold_layout(sizeof(T), block_q, pp, tile, C, sub, stride).total;
  cudaError_t err = cudaFuncSetAttribute(
      score_fold_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  dim3 grid1((Q + block_q - 1) / block_q, splits);
  score_fold_kernel<T><<<grid1, kThreads, smem1, st>>>(
      static_cast<const T*>(doc_codes), static_cast<const T*>(qcodes),
      static_cast<const float*>(col_weights),
      static_cast<const uint8_t*>(live), d, C, Q, block_q, log_pc, pp, tile,
      sub, stride, chunk, splits, static_cast<float*>(part_s),
      static_cast<int*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = (size_t)4 * pp * 4;
  merge_splits_kernel<<<Q, kThreads, smem2, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      splits, pp, page, d, static_cast<float*>(out_s),
      static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory bytes pass 1 needs for these launch sizes.
extern "C" long long fused_phase1_smem_bytes(int esize, int block_q,
                                             int page, int tile, int C,
                                             int sub, int stride) {
  return (long long)fold_layout(esize, block_q, 1 << log2_ceil(page), tile,
                                C, sub, stride).total;
}

#define FUSED_PHASE1_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* doc_codes, const void* qcodes,             \
                      const void* col_weights, const void* live, int d,      \
                      int C, int Q, int page, int block_q, int tile,         \
                      int sub, int stride, int chunk, int splits,            \
                      void* part_s, void* part_i, void* out_s, void* out_i,  \
                      void* stream) {                                        \
    return launch<T>(doc_codes, qcodes, col_weights, live, d, C, Q, page,    \
                     block_q, tile, sub, stride, chunk, splits, part_s,      \
                     part_i, out_s, out_i, stream);                          \
  }

FUSED_PHASE1_ENTRY(fused_phase1_int8, int8_t)
FUSED_PHASE1_ENTRY(fused_phase1_int16, int16_t)
FUSED_PHASE1_ENTRY(fused_phase1_int32, int32_t)
