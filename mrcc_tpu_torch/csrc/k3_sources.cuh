// Row sources of the k3 convs' tiles (gather_mma.cuh, and its int8
// counterpart q8_mma.cuh): Source::resolve(b, m0, n, nbr) fills the
// neighbour list nbr[k * BM + r] (the input row of offset k for output row
// m0 + r of item b, -1 for a miss) and ends with a barrier.
//   - KeySearch: the self-keyed convs (conv_sk.cu, conv_sk_q8.cu);
//   - NbrTable: the k3-table convs (conv_map.cu, conv_map_q8.cu).
// Both give the same list on one level, so the two k3 routes give the same
// bits.  A library that launches a tile names its own source type (derived
// from these), so that a profile tells its launches from another's.
#pragma once

#include "gather_gemm.cuh"  // k3_delta
#include "gather_mma.cuh"

namespace mrcc {
namespace tc {

// First row of the sorted key row krow[lo, n) whose key is >= q.
__device__ __forceinline__ int lower_bound(const int* __restrict__ krow,
                                           int lo, int n, int q) {
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(krow + mid) < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

constexpr int kRun = 8;  // rows of one search run
constexpr int kWalk = 8;  // forward steps before a run searches again

// The row source of the self-keyed conv: key + delta_k in the item's
// sorted key row, gated by the row's offset bit.  The queries of one
// offset rise with the row, and so do their places in the key row: a
// thread takes one offset over a run of 8 rows, binary-searches the first
// query and walks forward from there for the rest (a few steps: the
// neighbours of consecutive voxels sit close together in key order), so a
// 64-row tile resolves its 27 x 64 neighbours in one round of 216 threads.
struct KeySearch {
  const int* key;
  const int* kbits;

  __device__ __forceinline__ void resolve(int b, int m0, int n,
                                          int* nbr) const {
    static_assert(K3 * (BM / kRun) <= THREADS, "one run a thread");
    const int* krow = key + static_cast<size_t>(b) * n;
    const int* brow = kbits + static_cast<size_t>(b) * n;
    if (threadIdx.x < K3 * (BM / kRun)) {
      const int k = threadIdx.x / (BM / kRun);
      const int r0 = (threadIdx.x % (BM / kRun)) * kRun;
      const int delta = k3_delta(k);
      int p = -1;
      for (int r = r0; r < r0 + kRun; ++r) {
        const int row = m0 + r;
        int j = -1;
        if (row < n && ((__ldg(brow + row) >> k) & 1)) {
          if (k == 13) {
            j = row;
          } else {
            const int q = __ldg(krow + row) + delta;
            if (p < 0) {
              p = lower_bound(krow, 0, n, q);
            } else {
              for (int w = 0; w < kWalk && p < n && __ldg(krow + p) < q; ++w)
                ++p;
              if (p < n && __ldg(krow + p) < q) p = lower_bound(krow, p, n, q);
            }
            if (p < n && __ldg(krow + p) == q) j = p;
          }
        }
        nbr[k * BM + r] = j;
      }
    }
    __syncthreads();
  }
};

// The k3 table conv's row source: the neighbour tables of the level,
// nbr_idx / nbr_hit [27, B, n].
struct NbrTable {
  const int* idx;
  const uint8_t* hit;
  int batch;

  __device__ __forceinline__ void resolve(int b, int m0, int n,
                                          int* nbr) const {
    for (int e = threadIdx.x; e < K3 * BM; e += THREADS) {
      const int k = e / BM;
      const int row = m0 + e % BM;
      int j = -1;
      if (row < n) {
        const size_t o = (static_cast<size_t>(k) * batch + b) * n + row;
        if (hit[o]) j = idx[o];
      }
      nbr[e] = j;
    }
    __syncthreads();
  }
};

}  // namespace tc
}  // namespace mrcc
