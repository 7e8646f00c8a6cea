// Shared helpers of the CUDA-core int8 convs (conv_sk_q8.cu,
// conv_map_q8.cu through gather_gemm_q8.cuh; the key search also serves
// conv_sk.cu and conv_dw_sk.cu): a CTA owns TM output rows x TN output
// columns; 256 threads in a 16 x 16 grid each hold 4 x 4 outputs in f32
// registers, rows ty + 16 * i and columns tx + 16 * j, so the global
// stores of one warp are two runs of 16 consecutive columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mrcc {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int THREADS = 256;

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

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ out,
                                           const float (&acc)[4][4], int m0,
                                           int n0, int nrows, int cout) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= nrows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < cout) out[static_cast<size_t>(r) * cout + c] = from_f32<T>(acc[i][j]);
    }
  }
}

inline dim3 conv_grid(int nrows, int cout, int batch) {
  return dim3((nrows + TM - 1) / TM, (cout + TN - 1) / TN, batch);
}

}  // namespace mrcc
