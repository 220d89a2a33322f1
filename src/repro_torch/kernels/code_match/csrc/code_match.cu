// Code-match scoring kernel for Hopper (sm_90a): the full (Q, d) matrix
//
//   out[q, doc] = sum_c w[q, c] * [qcodes[q, c] == doc_codes[doc, c]]
//
// Replaces: src/repro/kernels/code_match/kernel.py::code_match_pallas
// (body _code_match_kernel).  The TPU kernel walks C in BLOCK_C chunks
// inside one (BLOCK_Q, BLOCK_D) output tile.  Here a block owns BLOCK_Q
// queries (codes and weights in shared memory) and one contiguous doc
// chunk; it stages the chunk's code rows `sub` at a time in shared memory
// (match_tree::stage_rows), and each thread scores one (query, doc) cell
// of the staged rows and writes it.  Neighbouring threads take
// neighbouring docs of one query, so the stores coalesce.
//
// The cell sums through match_tree.cuh's cell_score, the reference's
// match_scores tree kept in registers, four int8 codes per load and
// compare: the scores are bit-equal to match_scores, and within float
// tolerance of code_match_ref's plain sum over C.
//
// What bounds it on the H100: Q*d*C compare-select-adds on the CUDA cores
// (equality has no tensor-core form); the d*C code bytes and the Q*d*4
// output bytes move in a fraction of that time.
//
// What this simple design leaves for later: one cell per thread, so the
// query words and weights are loaded again for every doc; loads do not
// overlap compute.

#include <stdint.h>

#include "../../csrc/match_tree.cuh"

namespace {

using match_tree::align16;
using match_tree::kMaxLogC;
using match_tree::log2_ceil;

constexpr int kThreads = 512;

struct Layout {
  size_t w, qc, rows, total;
};

__host__ __device__ inline Layout layout(int esize, int block_q, int C,
                                         int sub, int stride) {
  Layout L;
  size_t o = 0;
  const size_t cp = match_tree::padded_cols(C);
  L.w = o;    o = align16(o + (size_t)block_q * cp * 4);
  L.qc = o;   o = align16(o + (size_t)block_q * cp * esize);
  L.rows = o; o = align16(o + (size_t)sub * stride * esize);
  L.total = o;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
code_match_kernel(const T* __restrict__ doc_codes,
                  const T* __restrict__ qcodes,
                  const float* __restrict__ col_weights, int d, int C, int Q,
                  int block_q, int log_pc, int sub, int stride, int chunk,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(sizeof(T), block_q, C, sub, stride);
  float* s_w = reinterpret_cast<float*>(smem + L.w);
  T* s_qc = reinterpret_cast<T*>(smem + L.qc);
  T* s_rows = reinterpret_cast<T*>(smem + L.rows);

  const int q0 = blockIdx.x * block_q;
  const int nq = min(block_q, Q - q0);
  const int cp = match_tree::padded_cols(C);
  match_tree::load_queries(s_qc, s_w, qcodes, col_weights, q0, nq, block_q,
                           C);

  const int d_lo = blockIdx.y * chunk;
  const int d_hi = min(d_lo + chunk, d);
  const int lsub = match_tree::log2_pow2(sub);
  for (int r0 = d_lo; r0 < d_hi; r0 += sub) {
    const int rows = min(sub, d_hi - r0);
    __syncthreads();            // the previous rows are scored
    match_tree::stage_rows(s_rows, doc_codes, r0, rows, C, stride);
    __syncthreads();
    for (int e = threadIdx.x; e < nq * sub; e += blockDim.x) {
      const int q = e >> lsub, j = e & (sub - 1);
      if (j < rows)
        out[(size_t)(q0 + q) * d + r0 + j] = match_tree::cell_score<T>(
            s_rows + j * stride, s_qc + q * cp, s_w + q * cp, C, log_pc);
    }
  }
}

template <typename T>
int launch(const void* doc_codes, const void* qcodes, const void* col_weights,
           int d, int C, int Q, int block_q, int sub, int stride, int chunk,
           int splits, void* out, void* stream) {
  if (C < 1 || C > (1 << kMaxLogC) || d < 1 || Q < 1 || block_q < 1 ||
      sub < 1 || (sub & (sub - 1)) || stride < C || chunk < 1 ||
      splits < 1 ||
      (long long)splits * chunk < d)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = layout(sizeof(T), block_q, C, sub, stride).total;
  cudaError_t err = cudaFuncSetAttribute(
      code_match_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + block_q - 1) / block_q, splits);
  code_match_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(doc_codes), static_cast<const T*>(qcodes),
      static_cast<const float*>(col_weights), d, C, Q, block_q, log2_ceil(C),
      sub, stride, chunk, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory bytes the kernel needs for these launch sizes.
extern "C" long long code_match_smem_bytes(int esize, int block_q, int C,
                                           int sub, int stride) {
  return (long long)layout(esize, block_q, C, sub, stride).total;
}

#define CODE_MATCH_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* doc_codes, const void* qcodes,             \
                      const void* col_weights, int d, int C, int Q,          \
                      int block_q, int sub, int stride, int chunk,           \
                      int splits, void* out, void* stream) {                 \
    return launch<T>(doc_codes, qcodes, col_weights, d, C, Q, block_q, sub,  \
                     stride, chunk, splits, out, stream);                    \
  }

CODE_MATCH_ENTRY(code_match_int8, int8_t)
CODE_MATCH_ENTRY(code_match_int16, int16_t)
CODE_MATCH_ENTRY(code_match_int32, int32_t)
