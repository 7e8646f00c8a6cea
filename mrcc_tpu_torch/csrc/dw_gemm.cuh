// Shared machinery of the weight-gradient kernels (conv_dw_sk.cu,
// conv_dw_map.cu):
//
//   dW[k] = sum over rows r (all items b, all rows i of the gradient g) of
//           [src_k(b, i) >= 0] * feats[b, src_k(b, i)]^T (x) g[b, i],
//
// a gather-GEMM whose product dimension is the B x N rows and whose output
// is the small [K, Cin, Cout] f32 block.  src_k is a device functor: the
// self-keyed neighbour search, the down conv's child map, or the up conv's
// parent / octant map.
//
// Determinism: no float atomics.  A CTA owns one (k, 64-wide Cin tile,
// 64-wide Cout tile) output block over one slice of the rows and writes a
// partial block; dw_reduce sums the slices in slice order.  Inside a CTA
// the rows are visited in order: each pass resolves THREADS candidate rows
// (one per thread), compacts the hits in row order with warp ballots, then
// stages DW_RB hit rows of feats and g at a time in shared memory (f32) and
// accumulates 4 x 4 outer products per thread in registers with FMA.  Rows
// whose offset bit or hit is off cost the search only.
#pragma once

#include "gather_gemm.cuh"

namespace mrcc {

constexpr int DW_TILE = 64;  // Cin and Cout extent of one CTA's block
constexpr int DW_RB = 32;    // hit rows staged in shared memory per FMA step

template <typename T, typename Source>
__global__ void __launch_bounds__(THREADS)
dw_kernel(Source src, const T* __restrict__ feats, const T* __restrict__ g,
          float* __restrict__ part, int batch, int n_in, int n_rows, int cin,
          int cout, int rows_per_slice) {
  __shared__ int fsrc[THREADS];  // feats row (b * n_in + j) of each hit
  __shared__ int gsrc[THREADS];  // g row (b * n_rows + i) of each hit
  __shared__ unsigned warp_hits[THREADS / 32];
  __shared__ float As[DW_RB][DW_TILE];
  __shared__ float Gs[DW_RB][DW_TILE];

  const int tiles_co = (cout + DW_TILE - 1) / DW_TILE;
  const int ci0 = (blockIdx.x / tiles_co) * DW_TILE;
  const int co0 = (blockIdx.x % tiles_co) * DW_TILE;
  const int k = blockIdx.y;
  const long long total = static_cast<long long>(batch) * n_rows;
  const long long r_begin = static_cast<long long>(blockIdx.z) * rows_per_slice;
  const long long r_end = min(total, r_begin + rows_per_slice);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  float acc[4][4] = {};
  for (long long base = r_begin; base < r_end; base += THREADS) {
    const long long r = base + threadIdx.x;
    int b = 0;
    int j = -1;
    if (r < r_end) {
      b = static_cast<int>(r / n_rows);
      j = src(k, b, static_cast<int>(r - static_cast<long long>(b) * n_rows));
    }
    const bool hit = j >= 0;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = mask;
    __syncthreads();
    int before = 0;
    int count = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      const int c = __popc(warp_hits[w]);
      if (w < warp) before += c;
      count += c;
    }
    if (hit) {
      const int pos = before + __popc(mask & ((1u << lane) - 1u));
      fsrc[pos] = b * n_in + j;
      gsrc[pos] = static_cast<int>(r);
    }
    __syncthreads();

    for (int h0 = 0; h0 < count; h0 += DW_RB) {  // count is uniform
      const int nh = min(DW_RB, count - h0);
      for (int e = threadIdx.x; e < DW_RB * DW_TILE; e += THREADS) {
        const int rr = e / DW_TILE;
        const int c = e % DW_TILE;
        float a = 0.f;
        float gv = 0.f;
        if (rr < nh) {
          const size_t fr = static_cast<size_t>(fsrc[h0 + rr]);
          const size_t gr = static_cast<size_t>(gsrc[h0 + rr]);
          if (ci0 + c < cin) a = to_f32(feats[fr * cin + ci0 + c]);
          if (co0 + c < cout) gv = to_f32(g[gr * cout + co0 + c]);
        }
        As[rr][c] = a;
        Gs[rr][c] = gv;
      }
      __syncthreads();
#pragma unroll 4
      for (int rr = 0; rr < nh; ++rr) {
        float a[4];
        float gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[rr][ty + 16 * i];
#pragma unroll
        for (int q = 0; q < 4; ++q) gv[q] = Gs[rr][tx + 16 * q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], gv[q], acc[i][q]);
      }
      __syncthreads();
    }
  }

  float* dst = part + (static_cast<size_t>(blockIdx.z) * gridDim.y + k) *
                          static_cast<size_t>(cin) * cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + ty + 16 * i;
    if (ci >= cin) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int co = co0 + tx + 16 * q;
      if (co < cout) dst[static_cast<size_t>(ci) * cout + co] = acc[i][q];
    }
  }
}

// out[e] = sum_{s < slices} part[s, e], in slice order.
__global__ void dw_reduce(const float* __restrict__ part,
                          float* __restrict__ out, long long size,
                          int slices) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < size; e += stride) {
    float s = 0.f;
    for (int z = 0; z < slices; ++z) s += part[z * size + e];
    out[e] = s;
  }
}

// dW [k, cin, cout] f32 into out.  slices > 1 needs part [slices, k, cin,
// cout] f32 scratch; with one slice the CTAs write out directly.
template <typename T, typename Source>
int dw_launch(Source src, const void* feats, const void* g, float* part,
              float* out, int batch, int n_in, int n_rows, int k, int cin,
              int cout, int slices, cudaStream_t stream) {
  if (k > 0 && cin > 0 && cout > 0 && slices > 0) {
    const long long total = static_cast<long long>(batch) * n_rows;
    const int rows_per_slice = static_cast<int>((total + slices - 1) / slices);
    const int tiles = ((cin + DW_TILE - 1) / DW_TILE) *
                      ((cout + DW_TILE - 1) / DW_TILE);
    const dim3 grid(tiles, k, slices);
    dw_kernel<T, Source><<<grid, THREADS, 0, stream>>>(
        src, static_cast<const T*>(feats), static_cast<const T*>(g),
        slices == 1 ? out : part, batch, n_in, n_rows, cin, cout,
        rows_per_slice);
    if (slices > 1) {
      const long long size = static_cast<long long>(k) * cin * cout;
      const long long want = (size + 255) / 256;
      const int blocks = static_cast<int>(want < 4096 ? want : 4096);
      dw_reduce<<<blocks, 256, 0, stream>>>(part, out, size, slices);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mrcc
