// Fused phase-1 search kernel for Hopper (sm_90a): weighted code-match
// scoring plus a running stable top-`page`, without a (Q, d) score matrix.
//
// Replaces: src/repro/kernels/fused_phase1/kernel.py::fused_phase1_pallas
// (body _fused_kernel, fold _fold_topk).  The two passes, their order and
// their limits are topk_fold.cuh's; this file gives the fold its cell
// scorer: the match_scores tree of match_tree.cuh, which makes the scores
// bit-equal to the reference's.
//
// What bounds it on the H100: it reads the d*C code bytes once per query
// tile, and does Q*d*C compare-select-adds on the CUDA cores -- equality
// has no tensor-core form -- so it is bound by operations, not bytes.
//
// The scorer (match_tree.cuh's cell_score) keeps the tree in registers
// and takes four int8 codes per load and compare.  What this design
// leaves for later: one cell per thread, so the query words and weights
// are loaded again for every doc (no register blocking over docs); the
// code rows are staged in shared memory by plain synchronous loads (no
// cp.async or TMA pipeline); every cell of a tile is scored before any is
// compared with the accumulator; tiles are scored with no overlap of
// loads and compute.
//
// Limits: C <= 4096 (the tree's depth), and the queries and staged rows must
// fit the card's shared memory; any page runs (topk_fold.cuh's workspace
// route past P2 = 8192).

#include "topk_fold.cuh"

namespace {

using match_tree::kMaxLogC;
using match_tree::log2_ceil;

// Queries in shared memory: the weights (qa, block_q rows of
// padded_cols(C) f32), then the query codes (qb, block_q rows of
// padded_cols(C) T), zero past C (match_tree::load_queries).
template <typename T>
struct MatchScorer {
  using Row = T;
  const T* qcodes;
  const float* col_weights;
  int C;
  int log_pc;

  __host__ __device__ size_t qa_bytes(int block_q) const {
    return (size_t)block_q * match_tree::padded_cols(C) * 4;
  }
  __host__ __device__ size_t qb_bytes(int block_q) const {
    return (size_t)block_q * match_tree::padded_cols(C) * sizeof(T);
  }
  __device__ void load(float* qa, unsigned char* qb, int q0, int nq,
                       int block_q) const {
    match_tree::load_queries(reinterpret_cast<T*>(qb), qa, qcodes,
                             col_weights, q0, nq, block_q, C);
  }
  __device__ float cell(const float* qa, const unsigned char* qb, int q,
                        const T* row, int /*doc*/) const {
    const int cp = match_tree::padded_cols(C);
    return match_tree::cell_score<T>(
        row, reinterpret_cast<const T*>(qb) + q * cp, qa + q * cp, C,
        log_pc);
  }
};

template <typename T>
int launch(const void* doc_codes, const void* qcodes, const void* col_weights,
           const void* live, int d, int C, int Q, int page, int block_q,
           int tile, int sub, int stride, int chunk, int splits, void* part_s,
           void* part_i, void* out_s, void* out_i, void* fold_ws,
           void* merge_ws, void* stream) {
  if (C < 1 || C > (1 << kMaxLogC)) return (int)cudaErrorInvalidValue;
  const MatchScorer<T> sc{static_cast<const T*>(qcodes),
                          static_cast<const float*>(col_weights), C,
                          log2_ceil(C)};
  return topk_fold::launch_fold(
      sc, static_cast<const T*>(doc_codes),
      static_cast<const uint8_t*>(live), d, C, Q, page, block_q, tile, sub,
      stride, chunk, splits, static_cast<float*>(part_s),
      static_cast<int*>(part_i), static_cast<float*>(out_s),
      static_cast<int*>(out_i), static_cast<int*>(fold_ws),
      static_cast<int*>(merge_ws), stream);
}

template <typename T>
long long smem_bytes(int block_q, int page, int tile, int C, int sub,
                     int stride, int spill) {
  const MatchScorer<T> sc{nullptr, nullptr, C, 0};
  return (long long)topk_fold::scorer_layout(sc, block_q,
                                             1 << log2_ceil(page), tile, sub,
                                             stride, spill != 0)
      .total;
}

}  // namespace

// Shared memory bytes pass 1 needs for these launch sizes, with the
// accumulator and tile in shared memory (spill 0) or in the workspace
// (spill 1); -1 for an element size the kernel does not take.
extern "C" long long fused_phase1_smem_bytes(int esize, int block_q,
                                             int page, int tile, int C,
                                             int sub, int stride, int spill) {
  switch (esize) {
    case 1:
      return smem_bytes<int8_t>(block_q, page, tile, C, sub, stride, spill);
    case 2:
      return smem_bytes<int16_t>(block_q, page, tile, C, sub, stride, spill);
    case 4:
      return smem_bytes<int32_t>(block_q, page, tile, C, sub, stride, spill);
    default: return -1;
  }
}

#define FUSED_PHASE1_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* doc_codes, const void* qcodes,             \
                      const void* col_weights, const void* live, int d,      \
                      int C, int Q, int page, int block_q, int tile,         \
                      int sub, int stride, int chunk, int splits,            \
                      void* part_s, void* part_i, void* out_s, void* out_i,  \
                      void* fold_ws, void* merge_ws, void* stream) {         \
    return launch<T>(doc_codes, qcodes, col_weights, live, d, C, Q, page,    \
                     block_q, tile, sub, stride, chunk, splits, part_s,      \
                     part_i, out_s, out_i, fold_ws, merge_ws, stream);       \
  }

FUSED_PHASE1_ENTRY(fused_phase1_int8, int8_t)
FUSED_PHASE1_ENTRY(fused_phase1_int16, int16_t)
FUSED_PHASE1_ENTRY(fused_phase1_int32, int32_t)
