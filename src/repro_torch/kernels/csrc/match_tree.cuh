// Device helpers shared by the hand-written kernels: the fp32 code-match
// scorer of one (query, doc) cell (fused_phase1, code_match), the staging
// of its queries, and the staging of doc rows in shared memory (every
// kernel).
//
// The reference (kernels/fused_phase1/ref.py::match_scores) sums the C
// selected weights with a halving tree over C zero-padded to
// PC = next_pow2(C): x[:h] + x[h:], repeated.  With four values left that
// is (a0 + a2) + (a1 + a3), where a_r is the same halving tree over the
// columns r, r + 4, r + 8, ... (PC / 4 of them).  So a 32-bit word of four
// int8 codes (columns 4m .. 4m + 3) gives one leaf to each of four
// interleaved subtrees, and cell_score runs the four side by side; int16
// codes give two subtrees (a0 + a1), int32 codes one.  Where PC is below
// the codes a word holds (C <= 2 for int8, C = 1 for int16), one word
// holds the whole tree.
//
// A halving tree over M = 2^L words is an adjacent-pair tree over the
// words taken in bit-reversed order.  cell_score walks that order in
// blocks of B = 2^U steps (U = min(L, kBlockLog)): block `blk` holds words
// bitrev(blk) + k * (M / B), k = bitrev(j) for steps j < B, folded by a
// carry chain whose shape is fixed at compile time; the block sums fold
// into each other by a carry chain over at most kMaxLogC levels, with
// predicated merges.  Every partial sum lives in a register: no array is
// indexed at run time, so no kernel has a stack frame.
//
// A leaf is w[q, c] where the codes match, else +0.0.  A word takes one
// 4-byte shared load of the doc word (conflict-free at stage_rows' odd
// word stride), one broadcast load of the query word, one broadcast
// vector load of its weights, an xor, and per code a mask test and a
// select.  The staged query rows are padded with zero weights to whole
// 4-column groups (load_queries), so a leaf past C selects +0.0 whatever
// the codes there, as the reference's padding does; words wholly past C
// push +0.0 without loading.  Only fp32 adds, in the reference's order, so
// the bits equal match_scores'.  Build without --use_fast_math: nothing
// may be flushed to zero.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace match_tree {

constexpr int kMaxLogC = 12;     // C <= 4096: the tree's depth
constexpr int kBlockLog = 4;     // steps of the fixed carry chain: 16 words

// Columns of a staged query row: C padded to whole 4-column groups, so a
// row is whole 32-bit words of codes and 16-byte groups of weights.
__host__ __device__ constexpr int padded_cols(int C) { return (C + 3) & ~3; }

template <typename T>
struct Packing {
  static constexpr int kPerWord = 4 / (int)sizeof(T);
  static constexpr int kLogPerWord = kPerWord == 4 ? 2 : kPerWord == 2 ? 1 : 0;
  static constexpr unsigned kMask = 0xffffffffu >> (32 - 8 * sizeof(T));
};

__host__ __device__ constexpr int bitrev(int x, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((x >> i) & 1) << (bits - 1 - i);
  return r;
}

__host__ __device__ constexpr int trailing_ones(int x) {
  int n = 0;
  while ((x >> n) & 1) ++n;
  return n;
}

// All threads of the block stage `nq` query rows from row q0 (codes and
// weights, C columns each) at a row stride of padded_cols(C); columns past
// C and rows past nq (up to block_q) are zero.
template <typename T>
__device__ __forceinline__ void load_queries(T* s_qc, float* s_w,
                                             const T* qcodes,
                                             const float* col_weights,
                                             int q0, int nq, int block_q,
                                             int C) {
  const int cp = padded_cols(C);
  for (int e = threadIdx.x; e < block_q * cp; e += blockDim.x) {
    const int q = e / cp, c = e - q * cp;
    const bool ok = q < nq && c < C;
    const size_t g = (size_t)(q0 + q) * C + c;
    s_qc[e] = ok ? qcodes[g] : T(0);
    s_w[e] = ok ? col_weights[g] : 0.0f;
  }
}

// The leaves of word m: the weight where a code matches, else +0.0;
// +0.0 for every code of a word at or past cw (the words that hold
// columns below C), with nothing loaded.
template <typename T>
__device__ __forceinline__ void word_leaves(
    const unsigned* d, const unsigned* q, const float* w, int m, int cw,
    float (&v)[Packing<T>::kPerWord]) {
  constexpr int G = Packing<T>::kPerWord;
#pragma unroll
  for (int r = 0; r < G; ++r) v[r] = 0.0f;
  if (m < cw) {
    const unsigned x = d[m] ^ q[m];
    float wr[G];
    if constexpr (G == 4) {
      const float4 t = reinterpret_cast<const float4*>(w)[m];
      wr[0] = t.x; wr[1] = t.y; wr[2] = t.z; wr[3] = t.w;
    } else if constexpr (G == 2) {
      const float2 t = reinterpret_cast<const float2*>(w)[m];
      wr[0] = t.x; wr[1] = t.y;
    } else {
      wr[0] = w[m];
    }
#pragma unroll
    for (int r = 0; r < G; ++r)
      v[r] = (x & (Packing<T>::kMask << (8 * (int)sizeof(T) * r))) ? 0.0f
                                                                    : wr[r];
  }
}

// Steps J.. of one block: step j takes word base + bitrev(j) * nb and
// folds it in with trailing_ones(j) merges; in[i] holds the pending sum
// of 2^i steps.  After the last step in[U] is the block's sum.
template <typename T, int U, int J>
__device__ __forceinline__ void fold_block(
    const unsigned* d, const unsigned* q, const float* w, int base, int lnb,
    int cw, float (&in)[U + 1][Packing<T>::kPerWord]) {
  if constexpr (J < (1 << U)) {
    constexpr int G = Packing<T>::kPerWord;
    constexpr int k = bitrev(J, U);
    constexpr int n = trailing_ones(J);
    float v[G];
    word_leaves<T>(d, q, w, base + (k << lnb), cw, v);
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int r = 0; r < G; ++r) v[r] = in[i][r] + v[r];
#pragma unroll
    for (int r = 0; r < G; ++r) in[n][r] = v[r];
    fold_block<T, U, J + 1>(d, q, w, base, lnb, cw, in);
  }
}

// The tree over 2^(U + lnb) words: 2^lnb blocks of 2^U steps, the blocks
// folded in order by a carry chain of predicated merges; then the
// subtrees combined as the reference's last levels combine them.
template <typename T, int U>
__device__ __forceinline__ float fold_words(const unsigned* d,
                                            const unsigned* q,
                                            const float* w, int cw,
                                            int lnb) {
  constexpr int G = Packing<T>::kPerWord;
  constexpr int kUp = kMaxLogC - Packing<T>::kLogPerWord - U;
  float up[kUp][G];
  float s[G];
#pragma unroll
  for (int i = 0; i < kUp; ++i)
#pragma unroll
    for (int r = 0; r < G; ++r) up[i][r] = 0.0f;
  const int nb = 1 << lnb;
  for (int blk = 0; blk < nb; ++blk) {
    const int base = lnb ? (int)(__brev((unsigned)blk) >> (32 - lnb)) : 0;
    float in[U + 1][G];
    fold_block<T, U, 0>(d, q, w, base, lnb, cw, in);
    const int n = __ffs(~blk) - 1;       // trailing ones: the merges
#pragma unroll
    for (int r = 0; r < G; ++r) s[r] = in[U][r];
#pragma unroll
    for (int i = 0; i < kUp; ++i)
      if (i < n)
#pragma unroll
        for (int r = 0; r < G; ++r) s[r] = up[i][r] + s[r];
#pragma unroll
    for (int i = 0; i < kUp; ++i)
      if (i == n)
#pragma unroll
        for (int r = 0; r < G; ++r) up[i][r] = s[r];
  }
  if constexpr (G == 4) return (s[0] + s[2]) + (s[1] + s[3]);
  else if constexpr (G == 2) return s[0] + s[1];
  else return s[0];
}

// The match_scores sum of one cell: `drow` a staged doc row of C codes
// (whole words), `qc` and `w` a staged query row (padded_cols(C) codes and
// weights, zero past C), log_pc = log2(next_pow2(C)).
template <typename T>
__device__ __forceinline__ float cell_score(const T* drow, const T* qc,
                                            const float* w, int C,
                                            int log_pc) {
  using P = Packing<T>;
  const unsigned* d = reinterpret_cast<const unsigned*>(drow);
  const unsigned* q = reinterpret_cast<const unsigned*>(qc);
  if (log_pc < P::kLogPerWord) {       // PC below the codes of a word
    float v[P::kPerWord];
    word_leaves<T>(d, q, w, 0, 1, v);
    if constexpr (P::kPerWord > 1)
      if (log_pc == 1) return v[0] + v[1];
    return v[0];
  }
  const int L = log_pc - P::kLogPerWord;
  const int cw = (C + P::kPerWord - 1) >> P::kLogPerWord;
  static_assert(kBlockLog == 4, "one case per block size below");
  switch (L) {
    case 0: return fold_words<T, 0>(d, q, w, cw, 0);
    case 1: return fold_words<T, 1>(d, q, w, cw, 0);
    case 2: return fold_words<T, 2>(d, q, w, cw, 0);
    case 3: return fold_words<T, 3>(d, q, w, cw, 0);
    default: return fold_words<T, 4>(d, q, w, cw, L - 4);
  }
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
