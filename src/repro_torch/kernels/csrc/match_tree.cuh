// Device helpers shared by the hand-written kernels: the fp32 code-match
// scorer of one (query, doc) cell (fused_phase1, code_match) and the
// staging of doc rows in shared memory (every kernel).
//
// The reference (kernels/fused_phase1/ref.py::match_scores) sums the C
// selected weights with a pairwise tree over C zero-padded to
// PC = next_pow2(C): x[i] + x[i+PC/2], repeated.  That tree is an
// adjacent-pair tree over the columns taken in BIT-REVERSED order, so one
// thread folds a cell by walking t = 0..PC-1, taking leaf c = bitrev(t)
// (w[q,c] on a code match, else +0.0, and +0.0 for c >= C), and merging
// partial sums on a stack like a binary counter.  Only fp32 adds, in the
// reference's order, so the bits equal match_scores'.  Build without
// --use_fast_math: nothing may be flushed to zero.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace match_tree {

constexpr int kMaxLogC = 12;     // C <= 4096: the depth of the stack

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

// Copy `rows` doc rows of `width` elements from global row r0 into shared
// memory at a row stride of `stride` elements (an odd number of 4-byte
// words: a warp reading one column of 32 staged rows hits 32 banks).  One
// warp per row, neighbouring lanes on neighbouring words, so the loads
// coalesce and no index is divided; rows of whole words on a word-aligned
// table move a word at a time.  All threads of the block take part.
template <typename T>
__device__ __forceinline__ void stage_rows(T* s_rows, const T* rows_g,
                                           int r0, int rows, int width,
                                           int stride) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int row_bytes = width * (int)sizeof(T);
  if ((row_bytes & 3) == 0 && (reinterpret_cast<uintptr_t>(rows_g) & 3) == 0) {
    const int wpr = row_bytes >> 2;
    const int swpr = (stride * (int)sizeof(T)) >> 2;
    const unsigned* src =
        reinterpret_cast<const unsigned*>(rows_g + (size_t)r0 * width);
    unsigned* dst = reinterpret_cast<unsigned*>(s_rows);
    for (int r = threadIdx.x >> 5; r < rows; r += nwarps)
      for (int c = lane; c < wpr; c += 32)
        dst[r * swpr + c] = src[(size_t)r * wpr + c];
  } else {
    for (int r = threadIdx.x >> 5; r < rows; r += nwarps)
      for (int c = lane; c < width; c += 32)
        s_rows[r * stride + c] = rows_g[(size_t)(r0 + r) * width + c];
  }
}

__device__ __forceinline__ int log2_pow2(int x) { return __ffs(x) - 1; }

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

inline int log2_ceil(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

}  // namespace match_tree
