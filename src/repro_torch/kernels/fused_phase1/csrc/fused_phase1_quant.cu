// Fused int8 phase-1 kernel for Hopper (sm_90a): scores of the queries
// against the dequantized rows of the per-row int8 table, plus a running
// stable top-`page`, without a (Q, d) score matrix.
//
// Replaces: src/repro/kernels/fused_phase1/kernel.py::
// fused_phase1_quant_pallas (body _fused_quant_kernel, fold _fold_topk).
// The two passes, their order and their limits are topk_fold.cuh's; this
// file gives the fold its cell scorer:
//
//   s[q, doc] = scale[doc] * (query[q] . codes8[doc]) + zero[doc] * qsum[q]
//
// the reference's factored form (core/quantize.py::quantized_scores): the
// dequantized row is never built.  One thread takes one cell: it walks the
// staged int8 row a 4-byte word at a time (the row stride is an odd
// number of words, so a warp's 32 rows sit in 32 banks) beside four query
// values from one 16-byte load, which the whole warp reads at one
// shared-memory address.  Each byte b becomes the float b exactly without
// the quarter-rate int-to-float unit: with its sign bit flipped it is the
// low byte of the float 2^23 + b + 128 (one byte permute), and one
// subtraction of 2^23 + 128 leaves b.  The fp32 FMAs run in column order,
// not the reference's matmul order, so scores agree to float tolerance,
// not bits (the `_assert_quant_parity` contract); the selection order is
// (score descending, id ascending), as in every fold.
//
// What bounds it on the H100: Q*d*n multiply-adds on the CUDA cores.  The
// queries are float32, so the int8 and TF32 tensor cores would round them
// beyond the contract's tolerance; the d*n code bytes are read once per
// query tile.  Operations bound it, not bytes.
//
// What this simple design leaves for later: one cell per thread, so each
// staged byte is widened once per query of the tile (no register blocking
// over queries); plain synchronous staging loads.

#include "topk_fold.cuh"

namespace {

using match_tree::log2_ceil;

// The signed byte of `u ^ 0x80808080` that selector `sel` picks (0x7440
// + byte index), as an exact float: the permute builds the float
// 2^23 + b + 128, the subtraction leaves b.
__device__ __forceinline__ float byte_value(unsigned u, unsigned sel) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.0f;
}

// Queries in shared memory: the values (qa, block_q x n f32), then their
// sums (qb, block_q f32).
struct QuantScorer {
  using Row = int8_t;
  const float* queries;
  const float* qsum;
  const float* scale;
  const float* zero;
  int n;

  __host__ __device__ size_t qa_bytes(int block_q) const {
    return (size_t)block_q * n * 4;
  }
  __host__ __device__ size_t qb_bytes(int block_q) const {
    return (size_t)block_q * 4;
  }
  __device__ void load(float* qa, unsigned char* qb, int q0, int nq,
                       int block_q) const {
    float* qs = reinterpret_cast<float*>(qb);
    for (int e = threadIdx.x; e < block_q * n; e += blockDim.x) {
      const int q = e / n;
      qa[e] = q < nq ? queries[(size_t)(q0 + q) * n + (e % n)] : 0.0f;
    }
    for (int q = threadIdx.x; q < block_q; q += blockDim.x)
      qs[q] = q < nq ? qsum[q0 + q] : 0.0f;
  }
  __device__ float cell(const float* qa, const unsigned char* qb, int q,
                        const int8_t* row, int doc) const {
    const float* x = qa + q * n;
    const unsigned* words = reinterpret_cast<const unsigned*>(row);
    const int n4 = n >> 2;
    float raw = 0.0f;
    if ((n & 3) == 0) {          // each query row starts 16-byte aligned
      const float4* x4 = reinterpret_cast<const float4*>(x);
      for (int k = 0; k < n4; ++k) {
        const float4 v = x4[k];
        const unsigned u = words[k] ^ 0x80808080u;
        raw = fmaf(v.x, byte_value(u, 0x7440), raw);
        raw = fmaf(v.y, byte_value(u, 0x7441), raw);
        raw = fmaf(v.z, byte_value(u, 0x7442), raw);
        raw = fmaf(v.w, byte_value(u, 0x7443), raw);
      }
    } else {
      for (int k = 0; k < n4; ++k) {
        const unsigned u = words[k] ^ 0x80808080u;
        raw = fmaf(x[4 * k], byte_value(u, 0x7440), raw);
        raw = fmaf(x[4 * k + 1], byte_value(u, 0x7441), raw);
        raw = fmaf(x[4 * k + 2], byte_value(u, 0x7442), raw);
        raw = fmaf(x[4 * k + 3], byte_value(u, 0x7443), raw);
      }
      for (int k = 4 * n4; k < n; ++k) raw = fmaf(x[k], (float)row[k], raw);
    }
    const float qs = reinterpret_cast<const float*>(qb)[q];
    return raw * scale[doc] + qs * zero[doc];
  }
};

}  // namespace

// Shared memory bytes pass 1 needs for these launch sizes, with the
// accumulator and tile in shared memory (spill 0) or in the workspace
// (spill 1).
extern "C" long long fused_phase1_quant_smem_bytes(int block_q, int page,
                                                   int tile, int n, int sub,
                                                   int stride, int spill) {
  const QuantScorer sc{nullptr, nullptr, nullptr, nullptr, n};
  return (long long)topk_fold::scorer_layout(sc, block_q,
                                             1 << log2_ceil(page), tile, sub,
                                             stride, spill != 0)
      .total;
}

extern "C" int fused_phase1_quant(const void* codes8, const void* scale,
                                  const void* zero, const void* queries,
                                  const void* qsum, const void* live, int d,
                                  int n, int Q, int page, int block_q,
                                  int tile, int sub, int stride, int chunk,
                                  int splits, void* part_s, void* part_i,
                                  void* out_s, void* out_i, void* fold_ws,
                                  void* merge_ws, void* stream) {
  if (n < 1 || stride % 4) return (int)cudaErrorInvalidValue;
  const QuantScorer sc{static_cast<const float*>(queries),
                       static_cast<const float*>(qsum),
                       static_cast<const float*>(scale),
                       static_cast<const float*>(zero), n};
  return topk_fold::launch_fold(
      sc, static_cast<const int8_t*>(codes8),
      static_cast<const uint8_t*>(live), d, n, Q, page, block_q, tile, sub,
      stride, chunk, splits, static_cast<float*>(part_s),
      static_cast<int*>(part_i), static_cast<float*>(out_s),
      static_cast<int*>(out_i), static_cast<int*>(fold_ws),
      static_cast<int*>(merge_ws), stream);
}
