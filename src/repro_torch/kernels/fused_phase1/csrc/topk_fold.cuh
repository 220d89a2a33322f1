// The running stable top-`page` fold shared by the fused phase-1 kernels
// (fused_phase1.cu: fp32 code match; fused_phase1_quant.cu: int8 rows).
//
// The TPU kernels walk the doc tiles IN ORDER on one core and keep a
// (BLOCK_Q, page) accumulator in a revisited output block.  Blocks on
// Hopper run in no order, so:
//
//   pass 1 (score_fold_kernel<Scorer>): grid (query tiles, doc splits).  A
//     block owns BLOCK_Q queries (in shared memory, laid out by the
//     scorer) and one contiguous doc split, which it walks tile by tile
//     INSIDE the block.  The doc rows of a tile are staged `sub` rows at a
//     time in shared memory (match_tree::stage_rows); each thread scores
//     (query, doc)
//     cells of the staged rows with the scorer (-inf for dead docs).  Of
//     each query's tile only the entries that rank ahead of the
//     accumulator's last entry can enter it: those are compacted to the
//     front, bitonic-sorted and merged into the block's running top-P2
//     accumulator (P2 = next_pow2(page)); once the accumulator has filled,
//     few entries of a tile pass, and a tile with none is skipped.  The
//     accumulator goes out as one sorted partial list per (query, split).
//   pass 2 (merge_splits_kernel): one block per query merges the split
//     lists into the final top-`page`, ids clamped to [0, d).
//
// Entries are ordered by (score descending, id ascending), a total order,
// so every fold is a selection under one order and the result equals one
// global stable top-k -- the same as jax.lax.top_k's lower-index-wins --
// whatever the split count or tile width.  No atomics: the result does
// not depend on scheduling.
//
// A Scorer is a struct passed by value to the kernel, with
//   using Row = <element type of a doc row>;
//   size_t qa_bytes(int block_q), qb_bytes(int block_q)   (host, device)
//   void load(float* qa, unsigned char* qb, int q0, int nq, int block_q)
//       -- all threads together stage the block's queries (device)
//   float cell(const float* qa, const unsigned char* qb, int q,
//              const Row* row, int doc)   -- one cell (device)
//
// Where the buffers live: the accumulator and the tile take 16 bytes per
// slot of P2 and query, so past P2 = 8192 they do not fit a block's shared
// memory on an H100 even at a query tile of one.  Then the wrapper hands
// pass 1 a device-memory workspace (`fold_ws`, one slice per block) and
// the accumulator and tile live there; the queries, the counts and the
// staged rows stay in shared memory.  The selection code is the same on
// either route: it takes plain pointers, and __syncthreads() orders a
// block's global accesses as it orders its shared ones.  Pass 2 keeps its
// accumulator (8 bytes per slot) in shared memory, or in `merge_ws` when
// that does not fit, and reads the split lists straight from `part`.
// Every buffer is allocated by the wrapper; the kernels allocate nothing.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/match_tree.cuh"

namespace topk_fold {

using match_tree::align16;
using match_tree::log2_ceil;
using match_tree::log2_pow2;

constexpr int kThreads = 512;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  // true when entry a ranks ahead of entry b
  return sa > sb || (sa == sb && ia < ib);
}

// Bitonic sort of `nseg` segments of `n` entries (n a power of two, at
// least 2; segment `seg` starts at seg * seg_stride), each into best-first
// order.  All threads of the block take part.  Every divisor is a power
// of two, taken as a shift and a mask.
__device__ void sort_segments(float* s, int* id, int nseg, int n,
                              int seg_stride) {
  const int half = n >> 1;
  const int lh = log2_pow2(n) - 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int lj = log2_pow2(j);
      for (int e = threadIdx.x; e < nseg * half; e += blockDim.x) {
        const int seg = e >> lh, p = e & (half - 1);
        const int i = ((p >> lj) << (lj + 1)) | (p & (j - 1));
        const int a = seg * seg_stride + i, b = a + j;
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
// sorts it.  n is a power of two.
__device__ void merge_into(float* acc_s, int* acc_i, const float* src_s,
                           const int* src_i, int nseg, int n,
                           int src_stride) {
  const int ln = log2_pow2(n);
  for (int e = threadIdx.x; e < nseg * n; e += blockDim.x) {
    const int seg = e >> ln, i = e & (n - 1);
    const int a = e, b = seg * src_stride + (n - 1 - i);
    if (before(src_s[b], src_i[b], acc_s[a], acc_i[a])) {
      acc_s[a] = src_s[b];
      acc_i[a] = src_i[b];
    }
  }
  __syncthreads();
  const int half = n >> 1;
  for (int j = half; j > 0; j >>= 1) {
    const int lj = log2_pow2(j);
    for (int e = threadIdx.x; e < nseg * half; e += blockDim.x) {
      const int seg = e >> (ln - 1), p = e & (half - 1);
      const int i = ((p >> lj) << (lj + 1)) | (p & (j - 1));
      const int a = (seg << ln) + i, b = a + j;
      if (before(acc_s[b], acc_i[b], acc_s[a], acc_i[a])) {
        const float ts = acc_s[a]; acc_s[a] = acc_s[b]; acc_s[b] = ts;
        const int ti = acc_i[a]; acc_i[a] = acc_i[b]; acc_i[b] = ti;
      }
    }
    __syncthreads();
  }
}

// Keep of each query's tile row only the entries that rank ahead of the
// accumulator's last entry -- no other can enter the top-P2 -- moved to
// the front of the row, and their count in count[q]; -> the largest count
// of the block.  One warp per row (block_q <= kThreads / 32), a ballot per
// 32 entries.  In place: every lane reads its entry before the ballot, and
// an entry only moves toward the front, into entries already read.
__device__ int compact_entrants(float* til_s, int* til_i, const float* acc_s,
                                const int* acc_i, int* count, int block_q,
                                int pp, int tile) {
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  if (q < block_q) {
    const float ts = acc_s[q * pp + pp - 1];
    const int ti = acc_i[q * pp + pp - 1];
    float* rs = til_s + q * tile;
    int* ri = til_i + q * tile;
    int n = 0;
    for (int c = 0; c < tile; c += 32) {
      const float sv = rs[c + lane];
      const int iv = ri[c + lane];
      const bool in = before(sv, iv, ts, ti);
      const unsigned m = __ballot_sync(0xffffffffu, in);
      if (in) {
        const int o = n + __popc(m & ((1u << lane) - 1u));
        rs[o] = sv;
        ri[o] = iv;
      }
      n += __popc(m);
    }
    if (lane == 0) count[q] = n;
  }
  __syncthreads();
  int most = 0;
  for (int k = 0; k < block_q; ++k) most = max(most, count[k]);
  return most;
}

// Byte offsets of score_fold_kernel's shared memory: the one layout the
// kernel addresses and the wrapper sizes its launch by.  Every buffer
// starts on a 16-byte boundary, so a scorer may read its queries and rows
// with vector loads.  With `spill` the accumulator and tile take no
// shared memory: they live in the workspace (fold_ws_words per block).
struct FoldLayout {
  size_t acc_s, acc_i, til_s, til_i, count, qa, qb, rows, total;
};

__host__ __device__ inline size_t fold_ws_words(int block_q, int pp,
                                                int tile) {
  return (size_t)block_q * (pp + tile) * 2;
}

__host__ __device__ inline FoldLayout fold_layout(int block_q, int pp,
                                                  int tile, size_t qa_bytes,
                                                  size_t qb_bytes,
                                                  size_t rows_bytes,
                                                  bool spill) {
  FoldLayout L;
  const size_t acc = spill ? 0 : (size_t)block_q * pp * 4;
  const size_t til = spill ? 0 : (size_t)block_q * tile * 4;
  size_t o = 0;
  L.acc_s = o; o = align16(o + acc);
  L.acc_i = o; o = align16(o + acc);
  L.til_s = o; o = align16(o + til);
  L.til_i = o; o = align16(o + til);
  L.count = o; o = align16(o + (size_t)block_q * 4);
  L.qa = o;    o = align16(o + qa_bytes);
  L.qb = o;    o = align16(o + qb_bytes);
  L.rows = o;  o = align16(o + rows_bytes);
  L.total = o;
  return L;
}

template <typename S>
__host__ __device__ inline FoldLayout scorer_layout(const S& sc, int block_q,
                                                    int pp, int tile,
                                                    int sub, int stride,
                                                    bool spill) {
  return fold_layout(block_q, pp, tile, sc.qa_bytes(block_q),
                     sc.qb_bytes(block_q),
                     (size_t)sub * stride * sizeof(typename S::Row), spill);
}

// Pass 1 (see the file note).
template <typename S>
__global__ void __launch_bounds__(kThreads)
score_fold_kernel(const S sc, const typename S::Row* __restrict__ rows_g,
                  const uint8_t* __restrict__ live, int d, int width, int Q,
                  int block_q, int pp, int tile, int sub, int stride,
                  int chunk, int splits, float* __restrict__ part_s,
                  int* __restrict__ part_i, int* __restrict__ fold_ws) {
  using Row = typename S::Row;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool spill = fold_ws != nullptr;
  const FoldLayout L =
      scorer_layout(sc, block_q, pp, tile, sub, stride, spill);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc_s);
  int* acc_i = reinterpret_cast<int*>(smem + L.acc_i);
  float* til_s = reinterpret_cast<float*>(smem + L.til_s);
  int* til_i = reinterpret_cast<int*>(smem + L.til_i);
  if (spill) {             // this block's slice of the workspace
    int* ws = fold_ws + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                            fold_ws_words(block_q, pp, tile);
    acc_s = reinterpret_cast<float*>(ws);
    acc_i = ws + (size_t)block_q * pp;
    til_s = reinterpret_cast<float*>(ws + (size_t)2 * block_q * pp);
    til_i = ws + (size_t)2 * block_q * pp + (size_t)block_q * tile;
  }
  int* count = reinterpret_cast<int*>(smem + L.count);
  float* s_qa = reinterpret_cast<float*>(smem + L.qa);
  unsigned char* s_qb = smem + L.qb;
  Row* s_rows = reinterpret_cast<Row*>(smem + L.rows);

  const int q0 = blockIdx.x * block_q;
  const int nq = min(block_q, Q - q0);
  const int split = blockIdx.y;

  sc.load(s_qa, s_qb, q0, nq, block_q);
  for (int e = threadIdx.x; e < block_q * pp; e += blockDim.x) {
    acc_s[e] = neg_inf();
    acc_i[e] = 0;
  }
  __syncthreads();

  const int d_lo = split * chunk;
  const int d_hi = min(d_lo + chunk, d);
  const int lsub = log2_pow2(sub);
  for (int base = d_lo; base < d_hi; base += tile) {
    for (int s0 = 0; s0 < tile; s0 += sub) {
      const int r0 = base + s0;
      const int rows = max(0, min(sub, d_hi - r0));
      match_tree::stage_rows(s_rows, rows_g, r0, rows, width, stride);
      __syncthreads();
      for (int e = threadIdx.x; e < block_q * sub; e += blockDim.x) {
        const int q = e >> lsub, j = e & (sub - 1);
        const int doc = r0 + j;
        float s = neg_inf();
        if (q < nq && j < rows && (live == nullptr || live[doc]))
          s = sc.cell(s_qa, s_qb, q, s_rows + j * stride, doc);
        til_s[q * tile + s0 + j] = s;
        til_i[q * tile + s0 + j] = doc;
      }
      __syncthreads();
    }
    // only entries ahead of the accumulator's last can enter it: sort
    // those (m, the next power of two of the most any query has), pad the
    // rest of what the merge reads with (-inf, INT_MAX), which never enters
    const int most =
        compact_entrants(til_s, til_i, acc_s, acc_i, count, block_q, pp, tile);
    if (most == 0) continue;
    const int m = max(2, 1 << (32 - __clz(most - 1)));
    const int w = max(m, pp), lw = log2_pow2(w);
    for (int e = threadIdx.x; e < block_q * w; e += blockDim.x) {
      const int q = e >> lw, i = e & (w - 1);
      if (i >= count[q]) {
        til_s[q * tile + i] = neg_inf();
        til_i[q * tile + i] = 0x7fffffff;
      }
    }
    __syncthreads();
    sort_segments(til_s, til_i, block_q, m, tile);
    merge_into(acc_s, acc_i, til_s, til_i, block_q, pp, tile);
  }

  for (int e = threadIdx.x; e < nq * pp; e += blockDim.x) {
    const int q = e / pp, i = e % pp;
    const size_t o = ((size_t)(q0 + q) * splits + split) * pp + i;
    part_s[o] = acc_s[e];
    part_i[o] = acc_i[e];
  }
}

// Pass 2: one block per query folds the split lists into an accumulator
// in shared memory (8 * pp bytes), or in `merge_ws` (pp slots a query)
// when that does not fit; the lists are read where pass 1 wrote them.
__global__ void __launch_bounds__(kThreads)
merge_splits_kernel(const float* __restrict__ part_s,
                    const int* __restrict__ part_i, int splits, int pp,
                    int page, int d, int* __restrict__ merge_ws,
                    float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  float* acc_s = reinterpret_cast<float*>(smem);
  int* acc_i = reinterpret_cast<int*>(acc_s + pp);
  if (merge_ws != nullptr) {
    acc_s = reinterpret_cast<float*>(merge_ws + (size_t)q * 2 * pp);
    acc_i = merge_ws + (size_t)q * 2 * pp + pp;
  }
  const size_t row = (size_t)q * splits * pp;
  for (int i = threadIdx.x; i < pp; i += blockDim.x) {
    acc_s[i] = part_s[row + i];
    acc_i[i] = part_i[row + i];
  }
  __syncthreads();
  for (int sp = 1; sp < splits; ++sp)
    merge_into(acc_s, acc_i, part_s + row + (size_t)sp * pp,
               part_i + row + (size_t)sp * pp, 1, pp, pp);
  for (int i = threadIdx.x; i < page; i += blockDim.x) {
    out_s[(size_t)q * page + i] = acc_s[i];
    out_i[(size_t)q * page + i] = min(acc_i[i], d - 1);
  }
}

inline size_t merge_smem_bytes(int pp) { return (size_t)8 * pp; }

// Both passes on `stream`; returns a cudaError_t (0 on success).  Launch
// sizes come from the wrapper and are checked here, not trusted.
// `fold_ws` (grid blocks x fold_ws_words ints) and `merge_ws` (Q x 2 pp
// ints) are null on the shared-memory routes.
template <typename S>
int launch_fold(const S& sc, const typename S::Row* rows,
                const uint8_t* live, int d, int width, int Q, int page,
                int block_q, int tile, int sub, int stride, int chunk,
                int splits, float* part_s, int* part_i, float* out_s,
                int* out_i, int* fold_ws, int* merge_ws, void* stream) {
  const int pp = 1 << log2_ceil(page);
  if (width < 1 || page < 1 || tile < pp || (tile & (tile - 1)) ||
      tile < 32 || sub < 1 || (sub & (sub - 1)) || sub > tile ||
      stride < width || d < 1 || Q < 1 || block_q < 1 ||
      block_q > kThreads / 32 || chunk % tile || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem1 =
      scorer_layout(sc, block_q, pp, tile, sub, stride, fold_ws != nullptr)
          .total;
  cudaError_t err = cudaFuncSetAttribute(
      score_fold_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  dim3 grid1((Q + block_q - 1) / block_q, splits);
  score_fold_kernel<S><<<grid1, kThreads, smem1, st>>>(
      sc, rows, live, d, width, Q, block_q, pp, tile, sub, stride, chunk,
      splits, part_s, part_i, fold_ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = merge_ws != nullptr ? 0 : merge_smem_bytes(pp);
  err = cudaFuncSetAttribute(merge_splits_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  merge_splits_kernel<<<Q, kThreads, smem2, st>>>(
      part_s, part_i, splits, pp, page, d, merge_ws, out_s, out_i);
  return (int)cudaGetLastError();
}

}  // namespace topk_fold
