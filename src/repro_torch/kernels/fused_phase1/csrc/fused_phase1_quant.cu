// Fused int8 phase-1 kernel for Hopper (sm_90a): scores of the queries
// against the per-row int8 table on the int8 tensor cores, plus a running
// stable top-`page`, without a (Q, d) score matrix.
//
// Replaces: src/repro/kernels/fused_phase1/kernel.py::
// fused_phase1_quant_pallas (body _fused_quant_kernel, fold _fold_topk).
// The two passes, their order and their limits are topk_fold.cuh's; this
// file gives the fold a tile scorer of
//
//   s[q, doc] = scale[doc] * (query[q] . codes8[doc]) + zero[doc] * qsum[q]
//
// the reference's factored form (core/quantize.py::quantized_scores): the
// dequantized row is never built.  The f32 queries go into the tensor
// cores as three int8 pieces each (quant_mma.cuh: the split, its error
// bound and the fixed combine), made once per block in `load`.  The
// codes go in as they are stored.  A warp owns 16 staged doc rows x 8
// queries: per k-step of 32 codes it loads one A fragment (ldmatrix.x4
// straight from the staged rows) and issues three
// mma.sync.m16n8k32.s8.s8.s32, one per piece, into exact int32 sums; it
// combines them in registers and writes its 16 x 8 scores (-inf for dead
// docs) into the fold's tile.  The scores are bit-equal to
// ref.py::quant_split_scores; against the reference's f32 product they
// differ by the split's error and the product's own rounding (the
// `_assert_quant_parity` contract).  The selection order is (score
// descending, id ascending), as in every fold.
//
// Staging: the fold keeps two buffers, and the next sub-block's rows are
// copied by cp.async while this one is scored.  Where the table's rows
// are 16-byte aligned (n % 16 == 0 and an aligned table), each row is
// copied in 16-byte pieces to a row stride of an odd number of 16-byte
// chunks (_build.mma_row_stride), so the eight rows an ldmatrix phase
// reads fall in distinct bank groups.  Otherwise the sub-block's bytes are
// copied as 4-byte words into one run (the rows back to back from the
// first row's byte within its word) and the A fragments are read with
// two word loads and a funnel shift each.  The word copies read only
// whole aligned words of the table, zero-filling past its last byte: the
// first may begin up to 3 bytes before the table, in the same aligned
// word as its first byte, never past the end.  Fragment reads that run
// past a row (to the k-step's end) or past the last row fall in the next
// row or the buffer's 64 bytes of slack, and meet zero query pieces.
//
// What bounds it on the H100: bytes.  2 * Q * d * padded_k(n) * 3 int8
// operations at 1,979 TOP/s are a third of the d * n code bytes at 3.35
// TB/s.  What this design leaves: the table is read once per query tile
// of 8 (L2 may catch the repeats), only sub / 16 warps run MMAs, two
// barriers per sub-block, and the fold's barriers, which take the largest
// share of the time once the scorer runs on the tensor cores.

#include "quant_mma.cuh"
#include "topk_fold.cuh"

namespace {

using match_tree::align16;
using match_tree::log2_ceil;
using quant_mma::kMmaK;
using quant_mma::kMmaM;
using quant_mma::kMmaN;
using quant_mma::kPieces;

__device__ __forceinline__ bool wide_rows(const int8_t* rows_g, int n,
                                          int stride) {
  return (n & 15) == 0 && (reinterpret_cast<uintptr_t>(rows_g) & 15) == 0 &&
         (stride & 15) == 0 && stride >= n;
}

// Queries in shared memory: the pieces (qa: kPieces x kMmaN rows of
// query_stride(n) bytes, zero past n and past the block's queries), then
// the row scales and sums (qb: kMmaN f32 each).
struct QuantScorer {
  using Row = int8_t;
  static constexpr bool kTileScorer = true;
  const float* queries;
  const float* qsum;
  const float* scale;
  const float* zero;
  int n;

  __host__ __device__ size_t qa_bytes(int) const {
    return (size_t)kPieces * kMmaN * quant_mma::query_stride(n);
  }
  __host__ __device__ size_t qb_bytes(int) const { return 2 * kMmaN * 4; }
  // A staging buffer: the rows (64 bytes of slack past them), then the
  // sub-block's scales and zeros.
  __host__ __device__ size_t params_at(int sub, int stride) const {
    return align16((size_t)sub * stride) + 64;
  }
  __host__ __device__ size_t rows_bytes(int sub, int stride) const {
    return params_at(sub, stride) + (size_t)sub * 8;
  }

  // One warp a query: its largest magnitude, its scale, its pieces.
  __device__ void load(float* qa, unsigned char* qb, int q0, int nq,
                       int) const {
    int8_t* pc = reinterpret_cast<int8_t*>(qa);
    float* qs = reinterpret_cast<float*>(qb);
    const int lane = threadIdx.x & 31;
    const int qst = quant_mma::query_stride(n);
    for (int q = threadIdx.x >> 5; q < kMmaN; q += blockDim.x >> 5) {
      const float* x = queries + (size_t)(q0 + q) * n;
      float m = 0.0f;
      if (q < nq)
        for (int k = lane; k < n; k += 32) m = fmaxf(m, fabsf(x[k]));
      for (int o = 16; o; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float s = quant_mma::row_scale(m);
      for (int k = lane; k < qst; k += 32) {
        int8_t p1 = 0, p2 = 0, p3 = 0;
        if (q < nq && k < n) quant_mma::split(x[k], s, &p1, &p2, &p3);
        pc[(0 * kMmaN + q) * qst + k] = p1;
        pc[(1 * kMmaN + q) * qst + k] = p2;
        pc[(2 * kMmaN + q) * qst + k] = p3;
      }
      if (lane == 0) {
        qs[q] = s;
        qs[kMmaN + q] = q < nq ? qsum[q0 + q] : 0.0f;
      }
    }
  }

  __device__ void stage(int8_t* buf, const int8_t* rows_g, int r0, int rows,
                        int sub, int stride) const {
    float* s_scale = reinterpret_cast<float*>(buf + params_at(sub, stride));
    for (int e = threadIdx.x; e < 2 * rows; e += blockDim.x) {
      const bool z = e >= rows;
      const int j = z ? e - rows : e;
      topk_fold::cp_async4(s_scale + (z ? sub : 0) + j,
                           (z ? zero : scale) + r0 + j, 4);
    }
    const int8_t* src = rows_g + (size_t)r0 * n;
    if (wide_rows(rows_g, n, stride)) {
      const int cpr = n >> 4;                 // 16-byte chunks a row
      for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
        const int r = e / cpr, c = e - r * cpr;
        topk_fold::cp_async16(buf + r * stride + c * 16,
                              src + (size_t)r * n + c * 16);
      }
    } else {
      const uintptr_t a = reinterpret_cast<uintptr_t>(src);
      const uintptr_t end = a + (size_t)rows * n;
      const uintptr_t a0 = a & ~(uintptr_t)3;
      const int words = (int)((end - a0 + 3) >> 2);
      for (int w = threadIdx.x; w < words; w += blockDim.x) {
        const uintptr_t s = a0 + 4 * (uintptr_t)w;
        topk_fold::cp_async4(buf + 4 * w, reinterpret_cast<const void*>(s),
                             (int)(end - s < 4 ? end - s : 4));
      }
    }
  }

  __device__ void score(const float* qa, const unsigned char* qb,
                        const int8_t* buf, const int8_t* rows_g, int r0,
                        int rows, int stride, int nq, int block_q,
                        const uint8_t* live, float* til_s, int* til_i,
                        int tile, int col0, int sub) const {
    const int8_t* pc = reinterpret_cast<const int8_t*>(qa);
    const float* qs = reinterpret_cast<const float*>(qb);
    const int lane = threadIdx.x & 31;
    const int g4 = lane >> 2, t4 = lane & 3;
    const int kp = quant_mma::padded_k(n);
    const int qst = quant_mma::query_stride(n);
    const bool wide = wide_rows(rows_g, n, stride);
    const int head =
        (int)(reinterpret_cast<uintptr_t>(rows_g + (size_t)r0 * n) & 3);
    const unsigned* words = reinterpret_cast<const unsigned*>(buf);
    const float* s_scale =
        reinterpret_cast<const float*>(buf + params_at(sub, stride));
    for (int j0 = (threadIdx.x >> 5) * kMmaM; j0 < sub;
         j0 += (blockDim.x >> 5) * kMmaM) {
      int c[kPieces][4] = {};
      for (int k0 = 0; k0 < kp; k0 += kMmaK) {
        unsigned a[4];
        if (wide) {
          quant_mma::ldmatrix_x4(
              a, buf + (j0 + (lane & 15)) * stride + k0 + (lane >> 4) * 16);
        } else {
          const int o0 = head + (j0 + g4) * n + k0 + t4 * 4;
          const int o1 = o0 + 8 * n;
          a[0] = quant_mma::load_u32_unaligned(words, o0);
          a[1] = quant_mma::load_u32_unaligned(words, o1);
          a[2] = quant_mma::load_u32_unaligned(words, o0 + 16);
          a[3] = quant_mma::load_u32_unaligned(words, o1 + 16);
        }
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          const int8_t* b = pc + (p * kMmaN + g4) * qst + k0 + t4 * 4;
          quant_mma::mma_s8(c[p], a, *reinterpret_cast<const unsigned*>(b),
                            *reinterpret_cast<const unsigned*>(b + 16));
        }
      }
      // c[p][h]: doc j0 + g4 (+ 8 for h >= 2), query 2 t4 + (h & 1)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int j = j0 + g4 + (h >> 1) * 8;
        const int q = 2 * t4 + (h & 1);
        if (q >= block_q) continue;
        const int doc = r0 + j;
        float s = topk_fold::neg_inf();
        if (q < nq && j < rows && (live == nullptr || live[doc]))
          s = quant_mma::combine(c[0][h], c[1][h], c[2][h], qs[q],
                                 s_scale[j], s_scale[sub + j], qs[kMmaN + q]);
        til_s[q * tile + col0 + j] = s;
        til_i[q * tile + col0 + j] = doc;
      }
    }
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
  if (n < 1 || stride % 16 || stride < n || sub % kMmaM ||
      block_q > kMmaN)
    return (int)cudaErrorInvalidValue;
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
