// Phase-2 candidate scoring kernel for Hopper (sm_90a), with the gather of
// the candidate rows fused in:
//
//   scores[q, p] = sum_j table[ids[q, p], j] * queries[q, j]
//
// Replaces: src/repro/kernels/rerank_topk/kernel.py::rerank_scores_pallas
// (body _rerank_kernel).  The TPU kernel takes the candidates already
// gathered into a (Q, P, n) tensor and lowers each (BLOCK_P, n) slab's
// product with the query to the MXU.  Here the kernel takes the (d, n)
// table and the (Q, P) int32 ids, so the (Q, P, n) tensor never exists.
// A block stages its query row in shared memory and owns kCandPerBlock
// candidates of it; each warp takes kCandPerWarp of them at once: its
// lanes read the candidates' rows (16 bytes a lane where a row is a whole
// number of float4s on a 16-byte aligned table, else a float a lane), all
// kCandPerWarp loads in flight together, multiply-add them with the staged
// query, and the warp sums each candidate's partials by shuffles.  Ids
// are clamped to [0, d), as the reference's gather clamps them.
//
// fp32 FMAs in another order than the reference einsum's: within the
// reference suite's rtol 1e-4 / atol 5e-5 (tests/test_kernels.py).
//
// What bounds it on the H100: bytes.  The Q*P candidate rows (n*4 bytes
// each) are read once, with 2 flops per element; at page 320 that is a
// few microseconds of traffic, so the launch dominates.
//
// What this simple design leaves for later: a query's rows are read by
// several blocks with no reuse across queries that share candidates; no
// cp.async pipeline.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCandPerWarp = 4;
constexpr int kCandPerBlock = (kThreads / 32) * kCandPerWarp;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
rerank_scores_kernel(const float* __restrict__ table,
                     const int* __restrict__ ids,
                     const float* __restrict__ queries, int d, int P, int n,
                     int p_blocks, int vec, float* __restrict__ out) {
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
  if (vec) {
    const float4* q4 = reinterpret_cast<const float4*>(s_q);
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
  } else {
    for (int k = lane; k < n; k += 32) {
      const float b = s_q[k];
#pragma unroll
      for (int c = 0; c < kCandPerWarp; ++c)
        acc[c] = fmaf(rows[c][k], b, acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kCandPerWarp; ++c) {
    const float s = warp_sum(acc[c]);
    if (lane == 0 && p0 + c < P) out[(size_t)q * P + p0 + c] = s;
  }
}

}  // namespace

// Shared memory the kernel needs for rows of n floats.
extern "C" long long rerank_scores_smem_bytes(int n) {
  return (long long)n * 4;
}

extern "C" int rerank_scores(const void* table, const void* ids,
                             const void* queries, int d, int Q, int P, int n,
                             void* out, void* stream) {
  if (d < 1 || Q < 1 || P < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const long long p_blocks = (P + kCandPerBlock - 1) / kCandPerBlock;
  if (p_blocks * Q >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int vec = (n % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(table) % 16 == 0);
  const size_t smem = (size_t)n * 4;
  cudaError_t err = cudaFuncSetAttribute(
      rerank_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  rerank_scores_kernel<<<(unsigned)(p_blocks * Q), kThreads, smem,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(ids),
      static_cast<const float*>(queries), d, P, n, (int)p_blocks, vec,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
