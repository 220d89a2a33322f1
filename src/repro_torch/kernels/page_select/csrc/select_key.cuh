// The order of the page selection (page_select.cu): each f32 score as a
// 32-bit key whose unsigned order is the order of the plain version,
// stable_topk's descending sort, and the key's three radix digits.
//
//   order_key: a larger key ranks first.  -0.0 is +0.0 (the sort compares
//     them equal, so they keep position order); every NaN is one key above
//     +inf (the sort puts NaNs first); -inf lies below every finite score.
//   digits: 11, 11 and 10 bits from the top; pass p histograms digit p of
//     the keys whose higher digits equal the prefix found so far.
//   rank_word: a (key, position) pair as one 64-bit word whose ascending
//     order is (key descending, position ascending), the page's order.
//
// Plain C++ apart from the qualifiers, so that with a stub cuda_runtime.h
// the host compiler builds the very code the kernels inline
// (tests/test_torch_page_select_host.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace select_key {

constexpr int kPasses = 3;
constexpr int kBins = 1 << 11;             // bins of the widest digit

__host__ __device__ __forceinline__ int shift(int pass) {
  return pass == 0 ? 21 : pass == 1 ? 10 : 0;
}

__host__ __device__ __forceinline__ int bins(int pass) {
  return pass == kPasses - 1 ? 1 << 10 : 1 << 11;
}

// u: the bits of an f32 score.
__host__ __device__ __forceinline__ uint32_t order_key(uint32_t u) {
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;    // NaN
  if (u == 0x80000000u) u = 0;                                 // -0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__host__ __device__ __forceinline__ uint32_t digit(uint32_t key, int pass) {
  return (key >> shift(pass)) & (uint32_t)(bins(pass) - 1);
}

// The digits of `key` above pass `pass` equal those of `prefix`.
__host__ __device__ __forceinline__ bool in_prefix(uint32_t key,
                                                   uint32_t prefix,
                                                   int pass) {
  return pass == 0 || ((key ^ prefix) >> shift(pass - 1)) == 0;
}

__host__ __device__ __forceinline__ uint64_t rank_word(uint32_t key,
                                                       uint32_t pos) {
  return ((uint64_t)~key << 32) | pos;
}

__host__ __device__ __forceinline__ uint32_t word_pos(uint64_t w) {
  return (uint32_t)w;
}

}  // namespace select_key
