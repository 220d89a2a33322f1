// The range cut of the posting walk (postings_walk.cu): where one token's
// posting range crosses the edges of the doc tiles, and which column a
// position of a block's flat list of entries belongs to.
//
// The invariant it rests on: build_postings sorts every column stably, so
// within one token's range [lo, hi) of post_docs[c] the doc ids ascend
// (core/postings.py's module doc).  So the entries of a range whose docs
// fall in the tile [k * tile, (k + 1) * tile) are one contiguous
// sub-range, [edge_cut(k), edge_cut(k + 1)), and edge_cut(k) is the
// first position whose doc is at least k * tile: a binary search.  The
// first edge cuts at lo and an edge at or past the table's d at hi, with
// no search; an empty range (hi <= lo) cuts at lo everywhere.
//
// Plain C++ apart from the qualifiers, so that with a stub cuda_runtime.h
// the host compiler builds the very code the kernels inline
// (tests/test_torch_postings_walk_host.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace walk_cut {

// First position p in [lo, hi) with docs[p] >= key, or hi; docs ascend
// on [lo, hi).
__host__ __device__ __forceinline__ int lower_bound(
    const int32_t* docs, int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (docs[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Position of the range [lo, hi) of one column's ascending doc ids at the
// tile edge whose first doc is `edge`, in a table of d docs.
__host__ __device__ __forceinline__ int edge_cut(
    const int32_t* docs, int lo, int hi, long long edge, int d) {
  if (hi <= lo || edge <= 0) return lo;
  if (edge >= d) return hi;
  return lower_bound(docs, lo, hi, (int)edge);
}

// The column of flat entry e: the largest c in [0, C) with off[c] <= e,
// where off (C + 1 values, off[0] = 0, off[C] = E > e) is the exclusive
// running sum of the columns' sub-range lengths.  Columns with no entry
// share their off with the next one, so the column found holds e.
__host__ __device__ __forceinline__ int find_col(const int* off, int C,
                                                 int e) {
  int lo = 0, hi = C;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= e)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

}  // namespace walk_cut
