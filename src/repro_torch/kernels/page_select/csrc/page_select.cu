// Page selection for Hopper (sm_90a): the page of a composed engine's dense
// (Q, d) f32 phase-1 scores, exactly what the plain version returns,
//
//   values (Q, page) f32, positions (Q, page) int64
//     = stable_topk(scores, page)              (core/rerank.py)
//
// ordered by (score descending, position ascending) under select_key.cuh's
// order: -0.0 ranks as +0.0, -inf below every finite score, ties at any
// score to the lower position.
//
// Replaces no TPU kernel: the JAX package cuts the page with lax.top_k
// (src/repro/core/search.py), which XLA compiles.  It was added because
// the plain version, a full stable sort of every row with int64
// positions, took 8.4 of the 11.7 device ms of a batch in the postings
// cell (Q 32, d 4,181,504, page 320) to keep 320 of 4.18M entries a row.
//
// Design: a radix threshold selection, after AIR top-k (Zhang et al.,
// SC'23).  Each score becomes a 32-bit key (select_key::order_key).
//   page_select_hist_kernel, once a digit (11, 11, 10 bits from the top):
//     a block a (query, split) streams its contiguous split of the row
//     with 16-byte loads and histograms in shared memory the digit of the
//     keys whose higher digits equal the query's prefix so far; one
//     histogram a (query, split).
//   page_select_scan_kernel after each: a block a query sums its splits'
//     histograms and takes the digit whose bin holds the need-th key from
//     the top (need = page less the keys found above so far): the prefix
//     grows by that digit, and the keys of the higher bins are counted, in
//     all and per split.  After the last digit the prefix is the exact
//     threshold key T, A keys rank above it, and the page takes need =
//     page - A of the keys equal to T, the first in position order.
//     Exclusive sums over the splits, in position order, place each
//     split's keys above T at [off_above, ...) and its keys equal to T at
//     A + [off_ties, ...).
//   page_select_write_kernel: each (query, split) reads its split again
//     and writes its keys above T, and its keys equal to T while the need
//     lasts, as rank words (select_key::rank_word), compacted in position
//     order by a block scan.
//   page_select_sort_kernel: a block orders each tile of kTile words of a
//     page in shared memory (bitonic).
//   page_select_rank_kernel: a word's place in the page is its place in
//     its tile plus the words of the other tiles below it (a binary search
//     each; none in a page of one tile); the position goes there, and the
//     score at that position is read back from the matrix, bit for bit.
// Counts are integers (shared-memory atomic adds in the histograms, block
// scans elsewhere) and every placement follows positions, so the result
// does not depend on scheduling.  No host synchronisation: the threshold
// never leaves the device.
//
// What bounds it on the H100: bytes.  The least is one read of the matrix,
// Q * d * 4 bytes (535 MB, 0.16 ms at the postings cell's shapes at
// 3.35 TB/s), and the page written.  This design reads the matrix four
// times (three histograms and the write), with 16-byte streaming loads,
// four in flight a thread, from two 512-thread blocks an SM (the launcher
// sizes the splits so that every block is resident at once).  Everything
// else -- histograms, the page's words, the sort -- is a few MB.
//
// What this design leaves for later: after the first digit, compacting the
// prefix's bin (few keys of 4.18M) into a small buffer would let the other
// two digits and the write read that buffer alone (AIR top-k's adaptive
// filter): two reads of the matrix instead of four.

#include <stdint.h>

#include "../../csrc/block_scan.cuh"
#include "select_key.cuh"

namespace {

using select_key::kBins;
using select_key::kPasses;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;                // resident blocks an SM
constexpr int kUnroll = 4;                   // 16-byte loads in flight
constexpr int kTile = 4096;                  // words a sort block orders
constexpr int kState = 3;                    // a query's state: prefix, A,
                                             // need

// One split [b, e) of a row: up to three scores before the first 16-byte
// boundary, whole float4s, up to three after the last.
struct Span {
  int head, n_head, vec, n_vec, tail, n_tail;
};

__device__ __forceinline__ Span span_of(const float* row, int b, int e) {
  Span s;
  const int mis = (int)((reinterpret_cast<uintptr_t>(row + b) & 15) >> 2);
  s.head = b;
  s.n_head = min(mis ? 4 - mis : 0, e - b);
  s.vec = b + s.n_head;
  s.n_vec = (e - s.vec) >> 2;
  s.tail = s.vec + 4 * s.n_vec;
  s.n_tail = e - s.tail;
  return s;
}

__device__ __forceinline__ uint32_t key_of(float x) {
  return select_key::order_key(__float_as_uint(x));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
page_select_hist_kernel(const float* __restrict__ scores, int d,
                        int n_splits, int split_len, int pass,
                        const uint32_t* __restrict__ state,
                        uint32_t* __restrict__ hist) {
  __shared__ uint32_t h[kBins];
  const int q = blockIdx.x / n_splits, s = blockIdx.x % n_splits;
  const int nb = select_key::bins(pass);
  for (int i = threadIdx.x; i < nb; i += kThreads) h[i] = 0;
  const uint32_t prefix = pass ? state[(size_t)q * kState] : 0u;
  __syncthreads();

  const float* row = scores + (size_t)q * d;
  const int b = s * split_len;
  const Span sp = span_of(row, b, min(d, b + split_len));
  auto add = [&](float x) {
    const uint32_t key = key_of(x);
    if (select_key::in_prefix(key, prefix, pass))
      atomicAdd(&h[select_key::digit(key, pass)], 1u);
  };
  const int t = threadIdx.x;
  if (t < sp.n_head) add(row[sp.head + t]);
  if (t < sp.n_tail) add(row[sp.tail + t]);
  const float4* v = reinterpret_cast<const float4*>(row + sp.vec);
  for (int i0 = 0; i0 < sp.n_vec; i0 += kUnroll * kThreads) {
    float4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads + t;
      if (i < sp.n_vec) x[u] = __ldcs(v + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * kThreads + t < sp.n_vec) {
        add(x[u].x);
        add(x[u].y);
        add(x[u].z);
        add(x[u].w);
      }
    }
  }
  __syncthreads();
  uint32_t* out = hist + (size_t)blockIdx.x * kBins;
  for (int i = threadIdx.x; i < nb; i += kThreads) out[i] = h[i];
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// split holds two ints a (query, split): the keys above the prefix's bins
// so far and, after the last digit, the keys equal to T; then both become
// the exclusive sums over the query's splits.
__global__ void __launch_bounds__(kThreads)
page_select_scan_kernel(const uint32_t* __restrict__ hist, int n_splits,
                        int pass, int page, uint32_t* __restrict__ state,
                        int* __restrict__ split) {
  __shared__ int scan[kWarps];
  __shared__ int s_digit, s_above;
  const int q = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int nb = select_key::bins(pass), per = nb / kThreads;
  uint32_t* st = state + (size_t)q * kState;
  const uint32_t prefix = pass ? st[0] : 0u;
  const int above0 = pass ? (int)st[1] : 0;
  const int need = pass ? (int)st[2] : page;
  const uint32_t* hq = hist + (size_t)q * n_splits * kBins;

  // thread t sums bins nb - 1 - t * per ... down, so the running sum in
  // thread order counts the keys of the higher bins
  int c[kBins / kThreads];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kBins / kThreads; ++j) {
    c[j] = 0;
    if (j < per) {
      const int bin = nb - 1 - (t * per + j);
      for (int s = 0; s < n_splits; ++s)
        c[j] += (int)hq[(size_t)s * kBins + bin];
      sum += c[j];
    }
  }
  int total;
  int higher = block_scan::exclusive_sum<kWarps>(sum, scan, &total);
#pragma unroll
  for (int j = 0; j < kBins / kThreads; ++j) {
    // the one bin whose keys straddle the need-th (total >= need >= 1)
    if (j < per && higher < need && higher + c[j] >= need) {
      s_digit = nb - 1 - (t * per + j);
      s_above = higher;
    }
    higher += c[j];
  }
  __syncthreads();
  const int D = s_digit, above = s_above;

  for (int s = warp; s < n_splits; s += kWarps) {
    const uint32_t* hs = hq + (size_t)s * kBins;
    int v = 0;
    for (int bin = D + 1 + lane; bin < nb; bin += 32) v += (int)hs[bin];
    v = warp_sum(v);
    if (lane == 0) {
      int* sp = split + ((size_t)q * n_splits + s) * 2;
      sp[0] = (pass ? sp[0] : 0) + v;
      if (pass == kPasses - 1) sp[1] = (int)hs[D];
    }
  }
  if (pass == kPasses - 1) {
    __syncthreads();                 // every split's counts are written
    int* sp = split + ((size_t)q * n_splits + t) * 2;
    const bool mine = t < n_splits;  // n_splits <= kThreads
    const int va = mine ? sp[0] : 0, vt = mine ? sp[1] : 0;
    int ta, tt;
    const int ea = block_scan::exclusive_sum<kWarps>(va, scan, &ta);
    __syncthreads();
    const int et = block_scan::exclusive_sum<kWarps>(vt, scan, &tt);
    if (mine) {
      sp[0] = ea;
      sp[1] = et;
    }
  }
  if (t == 0) {
    st[0] = prefix | ((uint32_t)D << select_key::shift(pass));
    st[1] = (uint32_t)(above0 + above);
    st[2] = (uint32_t)(need - above);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
page_select_write_kernel(const float* __restrict__ scores, int d,
                         int n_splits, int split_len, int page,
                         const uint32_t* __restrict__ state,
                         const int* __restrict__ split,
                         unsigned long long* __restrict__ cand) {
  __shared__ int scan[kWarps];
  const int q = blockIdx.x / n_splits, s = blockIdx.x % n_splits;
  const uint32_t T = state[(size_t)q * kState];
  const int A = (int)state[(size_t)q * kState + 1];
  const int need = (int)state[(size_t)q * kState + 2];
  const int off_above = split[(size_t)blockIdx.x * 2];
  const int off_ties = split[(size_t)blockIdx.x * 2 + 1];
  unsigned long long* out = cand + (size_t)q * page;
  int n_above = 0, n_ties = 0;       // this split's so far, block-uniform

  // One round: this thread's n scores at positions pos .. pos + n - 1,
  // after every earlier thread's of the round.  All threads call it.
  auto place = [&](const float (&x)[4], int n, int pos) {
    uint32_t key[4];
    int ca = 0, ct = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      key[j] = j < n ? key_of(x[j]) : 0u;
      ca += j < n && key[j] > T;
      ct += j < n && key[j] == T;
    }
    const int packed = ca | (ct << 16);      // at most 4 * kThreads each
    if (!__syncthreads_or(packed)) return;
    int total;
    const int ex = block_scan::exclusive_sum<kWarps>(packed, scan, &total);
    int ia = n_above + (ex & 0xffff), it = n_ties + (ex >> 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= n) continue;
      if (key[j] > T) {
        out[off_above + ia++] = select_key::rank_word(key[j], pos + j);
      } else if (key[j] == T) {
        if (off_ties + it < need)
          out[A + off_ties + it] = select_key::rank_word(key[j], pos + j);
        ++it;
      }
    }
    n_above += total & 0xffff;
    n_ties += total >> 16;
  };

  const float* row = scores + (size_t)q * d;
  const int b = s * split_len;
  const Span sp = span_of(row, b, min(d, b + split_len));
  const int t = threadIdx.x;
  {
    const float x[4] = {t < sp.n_head ? row[sp.head + t] : 0.0f, 0.f, 0.f,
                        0.f};
    place(x, t < sp.n_head, sp.head + t);
  }
  const float4* v = reinterpret_cast<const float4*>(row + sp.vec);
  for (int i0 = 0; i0 < sp.n_vec; i0 += kUnroll * kThreads) {
    float4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads + t;
      if (i < sp.n_vec) x[u] = __ldcs(v + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads + t;
      const float y[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
      place(y, i < sp.n_vec ? 4 : 0, sp.vec + 4 * i);
    }
  }
  {
    const float x[4] = {t < sp.n_tail ? row[sp.tail + t] : 0.0f, 0.f, 0.f,
                        0.f};
    place(x, t < sp.n_tail, sp.tail + t);
  }
}

__global__ void __launch_bounds__(kThreads)
page_select_sort_kernel(const unsigned long long* __restrict__ cand,
                        int page, int n_tiles,
                        unsigned long long* __restrict__ sorted) {
  __shared__ unsigned long long w[kTile];
  const int q = blockIdx.x / n_tiles, k = blockIdx.x % n_tiles;
  const int n = min(kTile, page - k * kTile);
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  const size_t base = (size_t)q * page + (size_t)k * kTile;
  for (int i = threadIdx.x; i < p2; i += kThreads)
    w[i] = i < n ? cand[base + i] : ~0ull;        // padding sorts last
  __syncthreads();
  for (int len = 2; len <= p2; len <<= 1) {
    for (int j = len >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p2; i += kThreads) {
        const int o = i ^ j;
        if (o > i) {
          const unsigned long long a = w[i], c = w[o];
          if ((a > c) == ((i & len) == 0)) {
            w[i] = c;
            w[o] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += kThreads) sorted[base + i] = w[i];
}

// Words of w[0, n), ascending and distinct, below x.
__device__ __forceinline__ int count_below(const unsigned long long* w,
                                           int n, unsigned long long x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (w[lo + half] < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
page_select_rank_kernel(const float* __restrict__ scores, int d, int page,
                        int n_tiles,
                        const unsigned long long* __restrict__ sorted,
                        float* __restrict__ out_val,
                        int64_t* __restrict__ out_pos) {
  const int q = blockIdx.x / n_tiles, k = blockIdx.x % n_tiles;
  const unsigned long long* pg = sorted + (size_t)q * page;
  const int n = min(kTile, page - k * kTile);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const unsigned long long x = pg[(size_t)k * kTile + i];
    int r = i;
    for (int u = 0; u < n_tiles; ++u)
      if (u != k)
        r += count_below(pg + (size_t)u * kTile,
                         min(kTile, page - u * kTile), x);
    const uint32_t pos = select_key::word_pos(x);
    out_pos[(size_t)q * page + r] = pos;
    out_val[(size_t)q * page + r] = scores[(size_t)q * d + pos];
  }
}

}  // namespace

// The kernels on `stream`, in order.  scores (Q, d) f32 row-major;
// n_splits (at most the block's threads) splits of split_len scores
// cover each row; n_tiles = ceil(page / kTile).  Workspace: hist
// (Q * n_splits * kBins u32), state (Q * kState u32), split (Q * n_splits
// * 2 int32), cand and sorted (Q * page u64 each).  out_val (Q, page) f32
// and out_pos (Q, page) int64 are written whole.
extern "C" int page_select(const void* scores, int Q, int d, int page,
                           int n_splits, int split_len, int n_tiles,
                           void* hist, void* state, void* split, void* cand,
                           void* sorted, void* out_val, void* out_pos,
                           void* stream) {
  if (Q < 1 || d < 1 || page < 1 || page > d || n_splits < 1 ||
      n_splits > kThreads || split_len < 1 ||
      (long long)split_len * n_splits < d ||
      (long long)split_len * (n_splits - 1) >= d ||
      n_tiles != (page + kTile - 1) / kTile ||
      (long long)Q * n_splits >= (1LL << 31) ||
      (long long)Q * n_tiles >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scores);
  uint32_t* h = static_cast<uint32_t*>(hist);
  uint32_t* qs = static_cast<uint32_t*>(state);
  int* sp = static_cast<int*>(split);
  unsigned long long* cw = static_cast<unsigned long long*>(cand);
  unsigned long long* sw = static_cast<unsigned long long*>(sorted);
  cudaError_t err;
  for (int pass = 0; pass < kPasses; ++pass) {
    page_select_hist_kernel<<<Q * n_splits, kThreads, 0, st>>>(
        s, d, n_splits, split_len, pass, qs, h);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    page_select_scan_kernel<<<Q, kThreads, 0, st>>>(h, n_splits, pass, page,
                                                     qs, sp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  page_select_write_kernel<<<Q * n_splits, kThreads, 0, st>>>(
      s, d, n_splits, split_len, page, qs, sp, cw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  page_select_sort_kernel<<<Q * n_tiles, kThreads, 0, st>>>(cw, page,
                                                            n_tiles, sw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  page_select_rank_kernel<<<Q * n_tiles, kThreads, 0, st>>>(
      s, d, page, n_tiles, sw, static_cast<float*>(out_val),
      static_cast<int64_t*>(out_pos));
  return (int)cudaGetLastError();
}
