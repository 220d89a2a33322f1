// The numerics of the int8 tensor-core scorer (fused_phase1_quant.cu): the
// f32 queries split into three int8 pieces, and the fixed combine of the
// pieces' exact integer sums into a score.
//
// A query row q (n values) gets one scale s = max|q| / 127, an f32
// division.  Each value x = q / s (an f32 division; |x| <= 127) splits
// into three integers with powers of two between them:
//
//   p1 = rn(x)                       in [-127, 127]
//   p2 = rn(128 (x - p1))            in [-64, 64]
//   p3 = rn(128 (128 (x - p1) - p2)) in [-64, 64]
//
// rn rounds half to even.  x - p1 and y - p2 are exact (the two operands
// lie within a factor of two of each other, or one is 0), and so is every
// product by 128, so the only rounding is the division q / s:
//
//   |q - s (p1 + p2 2^-7 + p3 2^-14)| <= s (2^-15 + 2^-18)
//
// (2^-15 from rn(z), 2^-18 from q / s at |x| < 128), for normal s; an
// all-zero row has s = 0 and every piece 0.  Pieces past n are 0, so the
// contraction axis pads to a multiple of 32 whatever the staged code
// bytes there hold.
//
// The kernel's sums A_i = sum_k p_i[k] codes8[doc, k] are exact int32
// (|A1| <= n 127 127, below 2^24 for n <= 1040, so each converts to f32
// exactly), and the combine is fixed and contraction-free:
//
//   raw   = s ((A1 + A2 2^-7) + A3 2^-14)
//   score = raw scale[doc] + qsum[q] zero[doc]
//
// each step one rounded f32 operation (__fmul_rn / __fadd_rn on the card,
// so nvcc cannot fuse two into an FMA).  ref.py::quant_split_scores takes
// the same f32 steps in the same order in torch, with the integer sums
// done exactly in float64, so the card's scores equal it bit for bit.
//
// split and combine are plain C++ off the card: the host tests compile
// them with a stub cuda_runtime.h (-ffp-contract=off) and hold them to
// the torch version.  The tensor-core and copy helpers below them are
// device code, compiled by nvcc only.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace quant_mma {

constexpr int kPieces = 3;
constexpr int kMmaM = 16;        // docs of one mma.sync tile
constexpr int kMmaN = 8;         // queries of one mma.sync tile
constexpr int kMmaK = 32;        // int8 codes of one k-step

// The contraction axis padded to whole k-steps.
__host__ __device__ constexpr int padded_k(int n) {
  return (n + kMmaK - 1) & ~(kMmaK - 1);
}

// Bytes per staged query piece row: padded_k(n) + 16, a word stride of
// 4 mod 8, so the eight rows a B-fragment load reads fall in distinct
// banks.
__host__ __device__ constexpr int query_stride(int n) {
  return padded_k(n) + 16;
}

__host__ __device__ inline float div_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
__host__ __device__ inline float mul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
__host__ __device__ inline float add_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
__host__ __device__ inline float sub_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
// round half to even
__host__ __device__ inline float round_even(float x) {
#if defined(__CUDA_ARCH__)
  return rintf(x);
#else
  return std::nearbyint(x);
#endif
}
__host__ __device__ inline float to_float(int a) {
#if defined(__CUDA_ARCH__)
  return __int2float_rn(a);
#else
  return (float)a;
#endif
}

// The row's scale from its largest magnitude.
__host__ __device__ inline float row_scale(float amax) {
  return div_rn(amax, 127.0f);
}

// One value's three pieces at row scale s (all 0 when s is 0).
__host__ __device__ inline void split(float q, float s, int8_t* p1,
                                      int8_t* p2, int8_t* p3) {
  if (!(s > 0.0f)) {
    *p1 = *p2 = *p3 = 0;
    return;
  }
  const float x = div_rn(q, s);
  const float f1 = round_even(x);
  const float y = mul_rn(sub_rn(x, f1), 128.0f);
  const float f2 = round_even(y);
  const float z = mul_rn(sub_rn(y, f2), 128.0f);
  *p1 = (int8_t)(int)f1;
  *p2 = (int8_t)(int)f2;
  *p3 = (int8_t)(int)round_even(z);
}

// The score of one (query, doc) cell from the pieces' exact sums.
__host__ __device__ inline float combine(int a1, int a2, int a3, float s,
                                         float scale, float zero,
                                         float qsum) {
  const float a12 = add_rn(to_float(a1), mul_rn(to_float(a2), 0x1p-7f));
  const float acc = add_rn(a12, mul_rn(to_float(a3), 0x1p-14f));
  const float raw = mul_rn(s, acc);
  return add_rn(mul_rn(raw, scale), mul_rn(qsum, zero));
}

#if defined(__CUDACC__)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The A fragment of m16n8k32 (16 rows x 32 int8) from shared memory: lane
// l gives the address of row (l & 15), byte 16 (l >> 4) of the k-step.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

// c += A (16 x 32 s8, row) * B (32 x 8 s8, col), exact in s32.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 32-bit little-endian word at any byte offset of a shared buffer
// whose words past the offset are readable.
__device__ __forceinline__ unsigned load_u32_unaligned(const unsigned* w,
                                                       int byte) {
  const unsigned lo = w[byte >> 2], hi = w[(byte >> 2) + 1];
  return __funnelshift_r(lo, hi, (byte & 3) * 8);
}

#endif  // __CUDACC__

}  // namespace quant_mma
