// Phase-2 candidate scoring kernels for Hopper (sm_90a), with the gather
// of the candidate rows fused in:
//
//   scores[q, p] = sum_j table[ids[q, p], j] * queries[q, j]
//
// Replaces: src/repro/kernels/rerank_topk/kernel.py::rerank_scores_pallas
// (body _rerank_kernel).  The TPU kernel takes the candidates already
// gathered into a (Q, P, n) tensor and lowers each (BLOCK_P, n) slab's
// product with the query to the MXU.  Here the kernels take the (d, n)
// table and the (Q, P) int32 ids, so the (Q, P, n) tensor never exists.
// Ids are clamped to [0, d), as the reference's gather clamps them.
//
// What bounds it on the H100: bytes.  Each candidate row (n * 4 bytes) is
// read once for 2 flops an element, some 0.5 flop a byte against the
// card's ridge of about 20 (fp32 CUDA cores), so the time is what the
// rows take to stream from HBM (page 8192 at Q 32 and n 400: 419 MB).
// Tensor cores would buy nothing: each row meets one query vector, a
// matrix-vector product with no reuse for an MMA tile to exploit.
//
// Two bodies, chosen by the launcher (kernel.py's launch plan) by shape
// and alignment, never on a failure:
//
// rerank_bulk_kernel -- n % 4 == 0 and a 16-byte aligned table and
//   queries.  Persistent blocks (one or two an SM) walk the work items
//   (q, tile of `rows` candidates) in query-major order with the grid as
//   stride.  Warp kConsumerWarps of a block is the producer: lane r loads
//   id r of the block's next item while it issues the current one (so no
//   copy waits on an id's round trip), clamps it, and issues one
//   cp.async.bulk (the copy engine, no tensor map: a row is 1-D and
//   contiguous; its L2 lines tagged evict-first, as a row is read once)
//   of that candidate's row into the item's stage of a ring of `stages`
//   stages in shared memory, on the stage's *full* mbarrier, whose
//   arrive.expect_tx covers the stage's bytes.  The query row rides a ring
//   of its own (`stages` slots, *q_full* / *q_empty* mbarriers) and is
//   copied only when the item's query differs from the previous item's, so
//   the producer runs up to `stages` items ahead, across query changes,
//   and no block waits on a query load or a __syncthreads once it has
//   started.  Each consumer warp waits on a stage's full barrier, dots its
//   rows (warp w takes rows w, w + kConsumerWarps, ...) with the staged
//   query -- lanes along the row, 16-byte shared-memory reads -- arrives
//   on the stage's *empty* barrier, and sums each row's lane partials by
//   shuffles; lane 0 writes the score.  At n = 400 the plan takes 24 rows
//   a stage (38.4 KB), 2 stages and 2 blocks an SM: 154 KB of rows in
//   flight an SM.  Measured (tools/rerank_study.py sweep), two large
//   stages a block beat four or eight smaller ones at the same bytes in
//   flight, and more blocks beat more stages; a likely reason is that a
//   block consumes its stages in order, so one late row holds up the
//   stages behind it, which independent blocks do not share.
//
// rerank_scores_kernel -- every other shape (n % 4 != 0, a table or
//   queries off 16-byte alignment, or n past what the ring fits).  A block
//   stages its query row and owns kCandPerBlock candidates of it; each warp
//   takes kCandPerWarp of them at once, its lanes reading the rows (16
//   bytes a lane where a row is a whole number of float4s on a 16-byte
//   aligned table, else a float a lane), all kCandPerWarp loads in flight.
//
// Both sum a row the same way: lane l takes float4s l, l + 32, ... (floats
// on the scalar path), four fmaf each in x, y, z, w order, then a warp
// shuffle tree (xor 16, 8, 4, 2, 1).  So the bulk body and the vector path
// of the other are bit-equal, and ref.lane_order_scores repeats their
// bits in torch.  fp32 FMAs in another order than the reference einsum's:
// within the reference suite's rtol 1e-4 / atol 5e-5 (tests/test_kernels.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCandPerWarp = 4;
constexpr int kCandPerBlock = (kThreads / 32) * kCandPerWarp;

constexpr int kConsumerWarps = 4;
constexpr int kBulkThreads = (kConsumerWarps + 1) * 32;
constexpr int kMaxRows = 32;                  // rows a stage, one a lane
constexpr int kRowsPerWarp = kMaxRows / kConsumerWarps;
constexpr int kBarBytes = 32;                 // 4 mbarriers a stage

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// An L2 policy that evicts the lines it tags first: rows read once.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// One contiguous global -> shared copy by the copy engine, counted on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The same, its L2 lines tagged with `policy`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)),
         "l"(policy) : "memory");
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

// Shared memory: full[S], empty[S], q_full[S], q_empty[S] mbarriers, then
// S query slots of n floats, then S stages of `rows` rows of n floats.
__global__ void __launch_bounds__(kBulkThreads)
rerank_bulk_kernel(const float* __restrict__ table,
                   const int* __restrict__ ids,
                   const float* __restrict__ queries, int d, int P, int n,
                   int rows_per_stage, int stages, int tiles,
                   long long items, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  uint64_t* q_full = empty + stages;
  uint64_t* q_empty = q_full + stages;
  float* qbuf = reinterpret_cast<float*>(smem + kBarBytes * stages);
  float* ring = qbuf + (size_t)stages * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
      mbar_init(q_full + s, 1);
      mbar_init(q_empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const uint32_t row_bytes = (uint32_t)n * 4;
  const long long stride = gridDim.x;
  // ring position of the rows, and of the query slots (one phase bit each)
  int stage = 0;
  uint32_t phase = 0;
  int cur_q = -1, qslot = -1;
  uint32_t qphase = 0;

  if (warp == kConsumerWarps) {                     // producer
    auto load_id = [&](long long item) -> int {
      const long long q = item / tiles;
      const int p = (int)(item - q * tiles) * rows_per_stage + lane;
      return (lane < rows_per_stage && p < P) ? ids[q * P + p] : 0;
    };
    const uint64_t policy = evict_first_policy();
    int next = blockIdx.x < items ? load_id(blockIdx.x) : 0;
    for (long long item = blockIdx.x; item < items; item += stride) {
      const int q = (int)(item / tiles);
      const int p0 = (int)(item - (long long)q * tiles) * rows_per_stage;
      const int rows = min(rows_per_stage, P - p0);
      const int id = min(max(next, 0), d - 1);
      if (item + stride < items) next = load_id(item + stride);
      if (q != cur_q) {
        qslot = qslot + 1 == stages ? 0 : qslot + 1;
        mbar_wait(q_empty + qslot, ((qphase >> qslot) & 1u) ^ 1u);
        qphase ^= 1u << qslot;
        if (lane == 0) {
          mbar_expect_tx(q_full + qslot, row_bytes);
          bulk_copy(qbuf + (size_t)qslot * n, queries + (size_t)q * n,
                    row_bytes, q_full + qslot);
        }
        cur_q = q;
      }
      mbar_wait(empty + stage, phase ^ 1u);
      if (lane == 0) mbar_expect_tx(full + stage, (uint32_t)rows * row_bytes);
      __syncwarp();
      if (lane < rows)
        bulk_copy(ring + ((size_t)stage * rows_per_stage + lane) * n,
                  table + (size_t)id * n, row_bytes, full + stage, policy);
      if (++stage == stages) { stage = 0; phase ^= 1u; }
    }
    return;
  }

  for (long long item = blockIdx.x; item < items; item += stride) {
    const int q = (int)(item / tiles);
    const int p0 = (int)(item - (long long)q * tiles) * rows_per_stage;
    const int rows = min(rows_per_stage, P - p0);
    if (q != cur_q) {
      if (cur_q >= 0) {                             // done with that query
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty + qslot);
      }
      qslot = qslot + 1 == stages ? 0 : qslot + 1;
      mbar_wait(q_full + qslot, (qphase >> qslot) & 1u);
      qphase ^= 1u << qslot;
      cur_q = q;
    }
    mbar_wait(full + stage, phase);
    const float4* q4 = reinterpret_cast<const float4*>(qbuf + (size_t)qslot * n);
    const float* base = ring + (size_t)stage * rows_per_stage * n;
    float acc[kRowsPerWarp];
#pragma unroll
    for (int c = 0; c < kRowsPerWarp; ++c) acc[c] = 0.0f;
    for (int k = lane; k < (n >> 2); k += 32) {
      const float4 b = q4[k];
#pragma unroll
      for (int c = 0; c < kRowsPerWarp; ++c) {
        const int r = warp + c * kConsumerWarps;
        if (r < rows) {
          const float4 a = reinterpret_cast<const float4*>(
              base + (size_t)r * n)[k];
          acc[c] = fmaf(a.x, b.x, acc[c]);
          acc[c] = fmaf(a.y, b.y, acc[c]);
          acc[c] = fmaf(a.z, b.z, acc[c]);
          acc[c] = fmaf(a.w, b.w, acc[c]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + stage);      // the stage is free
#pragma unroll
    for (int c = 0; c < kRowsPerWarp; ++c) {
      const int r = warp + c * kConsumerWarps;
      const float s = warp_sum(acc[c]);
      if (lane == 0 && r < rows) out[(size_t)q * P + p0 + r] = s;
    }
    if (++stage == stages) { stage = 0; phase ^= 1u; }
  }
}

}  // namespace

// Sets the dynamic shared memory limit of a body (0 bulk, 1 the other) to
// `smem` bytes; the launcher calls it only to raise a body's limit on a
// device, so a launch of any smaller size needs no call.
extern "C" int rerank_configure(int body, int smem) {
  const void* fn = body == 0 ? (const void*)rerank_bulk_kernel
                             : (const void*)rerank_scores_kernel;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

extern "C" int rerank_scores(const void* table, const void* ids,
                             const void* queries, int d, int Q, int P, int n,
                             void* out, void* stream) {
  if (d < 1 || Q < 1 || P < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const long long p_blocks = (P + kCandPerBlock - 1) / kCandPerBlock;
  if (p_blocks * Q >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int vec = (n % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(table) % 16 == 0);
  rerank_scores_kernel<<<(unsigned)(p_blocks * Q), kThreads, (size_t)n * 4,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(ids),
      static_cast<const float*>(queries), d, P, n, (int)p_blocks, vec,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The bulk body with the launch plan's rows a stage, stages, blocks and
// shared memory bytes; refuses a plan or inputs it does not take.
extern "C" int rerank_scores_bulk(const void* table, const void* ids,
                                  const void* queries, int d, int Q, int P,
                                  int n, int rows, int stages, int blocks,
                                  int smem, void* out, void* stream) {
  if (d < 1 || Q < 1 || P < 1 || n < 1 || n % 4 != 0 || rows < 1 ||
      rows > kMaxRows || stages < 1 || stages > 32 || blocks < 1 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(queries) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long need =
      (long long)stages * (kBarBytes + (long long)(rows + 1) * n * 4);
  if (need > smem) return (int)cudaErrorInvalidValue;
  const int tiles = (P + rows - 1) / rows;
  rerank_bulk_kernel<<<blocks, kBulkThreads, (size_t)smem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(ids),
      static_cast<const float*>(queries), d, P, n, rows, stages, tiles,
      (long long)Q * tiles, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
