// Posting-list walk for Hopper (sm_90a): the dense (Q, d) scores of the
// `postings` engine,
//
//   out[q, doc] = the sum, from +0.0 and in increasing column order, of
//                 w[q, c] over the columns c whose range [lo[q, c],
//                 hi[q, c]) of post_docs[c] holds doc.
//
// Replaces no TPU kernel: the JAX package's walk
// (src/repro/core/postings.py::score_postings_batch) is a plain
// segment_sum over a (C, max_postings) window.  The plain version here is
// ../ref.py: the kept ranges expanded into int64 positions, targets and
// values, and one index_add_ round a column.
//
// Design.  The doc ids of one token's range ascend (walk_cut.cuh), so the
// part of a range in the doc tile [D0, D0 + tile) is one contiguous
// sub-range.  postings_cut_kernel finds every range's position at every
// tile edge, a binary search each, into `cuts` (Q, n_tiles + 1, C).
// postings_walk_kernel gives a block one (query, tile): the tile's f32
// scores live in shared memory, and the sub-ranges of the query's C
// columns form one flat list of entries (an exclusive running sum of
// their lengths).  The block walks that list a chunk of kChunk entries at
// a time: the chunk's doc ids are staged in shared memory, the next
// chunk's are loaded into registers meanwhile, and the chunk's columns are
// added in increasing order, a barrier before each, a thread an entry.
// Within a column no doc repeats, so no two threads touch one cell between
// two barriers: no atomics, and every cell is summed from +0.0 in column
// order, the plain version's bits.  The tile is written once; no cell of
// the (Q, d) output takes a read-modify-write in device memory.
//
// What bounds it on the H100: bytes, in principle.  Each walked entry's
// int32 doc id is read once (4 B an entry) and each output cell written
// once (Q*d*4); the cut's searches read about log2(range) ids at each tile
// edge, the top of each search shared by all the edges of a range (L2).
// In practice the chain of column barriers bounds it: a block takes about
// C barriers a tile whatever the tile holds, so the tile is as wide as
// shared memory allows (two blocks an SM, the launcher's choice; one or
// three are slower), and a chunk of 8,192 ids keeps enough loads in
// flight that a barrier rarely waits on device memory.  At the postings
// cell's shapes (Q 32, d 4,181,504, C 400, about 483M entries) the walk
// takes about 3.1 ms against 0.74 ms of bytes (PERF.md, NVIDIA H100 80GB
// HBM3).
//
// What this design leaves for later: a barrier per column a tile, even
// where the column holds few entries there.  Giving each warp a doc range
// of the tile, with the chunk's entries partitioned stably by warp, would
// order a column's adds by warp alone.

#include <stdint.h>

#include "../../csrc/block_scan.cuh"
#include "walk_cut.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                    // doc ids a thread loads a chunk
constexpr int kChunk = kThreads * kPer;     // entries a chunk

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

struct Layout {
  size_t tile, chunk, off, beg, w, scan, total;
};

__host__ __device__ inline Layout layout(int tile, int C) {
  Layout L;
  size_t o = 0;
  L.tile = o; o = align16(o + (size_t)tile * 4);       // f32 scores
  L.chunk = o; o = align16(o + (size_t)kChunk * 4);    // staged doc ids
  L.off = o;  o = align16(o + (size_t)(C + 1) * 4);    // running sum
  L.beg = o;  o = align16(o + (size_t)C * 4);          // sub-range starts
  L.w = o;    o = align16(o + (size_t)C * 4);          // weights
  L.scan = o; o = align16(o + (size_t)kWarps * 4);     // warp totals
  L.total = o;
  return L;
}

__global__ void __launch_bounds__(kThreads)
postings_cut_kernel(const int32_t* __restrict__ docs, long long row_stride,
                    const int32_t* __restrict__ lo,
                    const int32_t* __restrict__ hi, int d, int C, int Q,
                    int tile, int n_tiles, int32_t* __restrict__ cuts) {
  const long long edges = n_tiles + 1;
  const long long n = (long long)Q * edges * C;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const int c = (int)(i % C);
    const long long qk = i / C;
    const int k = (int)(qk % edges);
    const int q = (int)(qk / edges);
    cuts[i] = walk_cut::edge_cut(docs + (size_t)c * row_stride,
                                 lo[(size_t)q * C + c], hi[(size_t)q * C + c],
                                 (long long)k * tile, d);
  }
}

// This thread's kPer doc ids of the chunk of flat entries from `base`
// (entry base + j * kThreads + thread), 0 past the last entry.
__device__ inline void load_chunk(const int32_t* __restrict__ docs,
                                  long long row_stride, const int* s_off,
                                  const int* s_beg, int C, int base,
                                  int n_entries, int (&v)[kPer]) {
  int c = walk_cut::find_col(s_off, C,
                             min(base + (int)threadIdx.x, n_entries - 1));
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = base + j * kThreads + threadIdx.x;
    v[j] = 0;
    if (e < n_entries) {
      while (s_off[c + 1] <= e) ++c;      // columns only grow with e
      v[j] = docs[(size_t)c * row_stride + s_beg[c] + (e - s_off[c])];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
postings_walk_kernel(const int32_t* __restrict__ docs, long long row_stride,
                     const int32_t* __restrict__ cuts,
                     const float* __restrict__ weights, int d, int C,
                     int tile, int n_tiles, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(tile, C);
  float* s_tile = reinterpret_cast<float*>(smem + L.tile);
  int* s_chunk = reinterpret_cast<int*>(smem + L.chunk);
  int* s_off = reinterpret_cast<int*>(smem + L.off);
  int* s_beg = reinterpret_cast<int*>(smem + L.beg);
  float* s_w = reinterpret_cast<float*>(smem + L.w);
  int* s_scan = reinterpret_cast<int*>(smem + L.scan);

  const int q = blockIdx.x / n_tiles, k = blockIdx.x % n_tiles;
  const int d0 = k * tile;
  const int width = min(tile, d - d0);
  const int32_t* cut0 = cuts + ((size_t)q * (n_tiles + 1) + k) * C;
  const int32_t* cut1 = cut0 + C;

  for (int i = threadIdx.x; i < width; i += kThreads) s_tile[i] = 0.0f;

  // each thread a run of columns: starts, weights, lengths, then their
  // place in the flat list
  const int per = (C + kThreads - 1) / kThreads;
  const int c_lo = min(C, (int)threadIdx.x * per);
  const int c_hi = min(C, c_lo + per);
  int sum = 0;
  for (int c = c_lo; c < c_hi; ++c) {
    const int a = cut0[c], len = cut1[c] - a;
    s_beg[c] = a;
    s_w[c] = weights[(size_t)q * C + c];
    s_off[c + 1] = len;
    sum += len;
  }
  int n_entries;
  int run = block_scan::exclusive_sum<kWarps>(sum, s_scan, &n_entries);
  for (int c = c_lo; c < c_hi; ++c) {
    run += s_off[c + 1];
    s_off[c + 1] = run;
  }
  if (threadIdx.x == 0) s_off[0] = 0;
  __syncthreads();

  // the chunk ahead is loaded into registers while this one's columns
  // are added from shared memory
  int v[kPer];
  if (n_entries > 0)
    load_chunk(docs, row_stride, s_off, s_beg, C, 0, n_entries, v);
  for (int base = 0; base < n_entries; base += kChunk) {
    __syncthreads();                      // the last chunk's adds are done
#pragma unroll
    for (int j = 0; j < kPer; ++j) s_chunk[j * kThreads + threadIdx.x] = v[j];
    const int top = min(base + kChunk, n_entries);
    if (top < n_entries)
      load_chunk(docs, row_stride, s_off, s_beg, C, top, n_entries, v);
    const int c_first = walk_cut::find_col(s_off, C, base);
    const int c_last = walk_cut::find_col(s_off, C, top - 1);
    for (int c = c_first; c <= c_last; ++c) {
      const int e0 = max(s_off[c], base), e1 = min(s_off[c + 1], top);
      if (e0 >= e1) continue;             // the same for every thread
      __syncthreads();                    // column c - 1 is added; c_first's
                                          // barrier also publishes the chunk
      const float wc = s_w[c];
      for (int e = e0 + (int)threadIdx.x; e < e1; e += kThreads) {
        const unsigned r = (unsigned)(s_chunk[e - base] - d0);
        if (r < (unsigned)width) s_tile[r] += wc;
      }
    }
  }
  __syncthreads();
  float* o = out + (size_t)q * d + d0;
  for (int i = threadIdx.x; i < width; i += kThreads) o[i] = s_tile[i];
}

}  // namespace

// Shared memory bytes postings_walk_kernel needs for a tile of `tile`
// docs over C columns.
extern "C" long long postings_walk_smem_bytes(int tile, int C) {
  return (long long)layout(tile, C).total;
}

// Both kernels on `stream`: cuts (Q * (n_tiles + 1) * C int32) is the
// caller's workspace, out (Q, d) f32 is written whole.  lo and hi are
// (Q, C) int32 positions in each row of post_docs (row_stride int32
// apart), hi <= lo for a token not walked; weights (Q, C) f32.
extern "C" int postings_walk(const void* docs, long long row_stride,
                             const void* lo, const void* hi,
                             const void* weights, int d, int C, int Q,
                             int tile, int n_tiles, int cut_blocks,
                             void* cuts, void* out, void* stream) {
  if (d < 1 || C < 1 || Q < 1 || tile < 1 || n_tiles < 1 ||
      (long long)tile * n_tiles < d || (long long)tile * (n_tiles - 1) >= d ||
      (long long)Q * n_tiles >= (1LL << 31) || cut_blocks < 1 ||
      row_stride < d)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  postings_cut_kernel<<<cut_blocks, kThreads, 0, st>>>(
      static_cast<const int32_t*>(docs), row_stride,
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi), d, C,
      Q, tile, n_tiles, static_cast<int32_t*>(cuts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = layout(tile, C).total;
  err = cudaFuncSetAttribute(postings_walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  postings_walk_kernel<<<Q * n_tiles, kThreads, smem, st>>>(
      static_cast<const int32_t*>(docs), row_stride,
      static_cast<const int32_t*>(cuts), static_cast<const float*>(weights),
      d, C, tile, n_tiles, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
