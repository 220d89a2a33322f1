// Block-wide exclusive running sum of one int a thread, shared by the
// posting walk (postings_walk.cu) and the page selection (page_select.cu).

#pragma once

#include <cuda_runtime.h>

namespace block_scan {

// Exclusive running sum of v over a block of kWarps full warps, in thread
// order; *total gets the whole sum.  scan holds kWarps ints of shared
// memory.  Every thread of the block calls it; it holds two barriers, and
// the caller puts a barrier between a call's last read of *total and the
// next call's use of the same scan.
template <int kWarps>
__device__ inline int exclusive_sum(int v, int* scan, int* total) {
  static_assert(kWarps >= 1 && kWarps <= 32, "one warp scans the totals");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? scan[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kWarps) scan[lane] = t;
  }
  __syncthreads();
  *total = scan[kWarps - 1];
  return x - v + (warp ? scan[warp - 1] : 0);
}

}  // namespace block_scan
