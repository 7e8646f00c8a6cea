// Key helpers of the self-keyed k3 convs: the packed key delta of each
// offset and a binary search in an item's sorted key row (k3_sources.cuh's
// KeySearch for the convs' tiles, hit_lists.cu for a level's k3 lists).
#pragma once

#include <cuda_runtime.h>

namespace mrcc {

// Packed key delta of K3_OFFSETS[k] (x slowest, z fastest; k = 13 is the
// identity, and delta(26 - k) == -delta(k)).
__device__ __forceinline__ int k3_delta(int k) {
  const int dx = k / 9 - 1;
  const int dy = (k / 3) % 3 - 1;
  const int dz = k % 3 - 1;
  return dx * (1 << 20) + dy * (1 << 10) + dz;
}

// Row of the sorted key row krow[0, n) equal to q, or -1 (binary search;
// the row is L2-resident at the main path's sizes).
__device__ __forceinline__ int find_key(const int* __restrict__ krow, int n,
                                        int q) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(krow + mid) < q) lo = mid + 1; else hi = mid;
  }
  return (lo < n && __ldg(krow + lo) == q) ? lo : -1;
}

}  // namespace mrcc
