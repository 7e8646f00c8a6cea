// Shared tile machinery of the int8 gather-GEMM convolutions (conv_sk_q8.cu,
// conv_map_q8.cu), on gather_gemm.cuh's tile: a CTA owns TM output rows x
// TN output columns, 256 threads in a 16 x 16 grid, 4 x 4 outputs each.
//
// Operands are int32 words of four consecutive int8 input channels: the
// activations [rows, cw] and each weight slice [cw, cout] (the wrapper packs
// them).  Gathered rows stage through shared memory as words (-1 = zero
// row), KW words = 32 channels per stage, and __dp4a multiplies four int8
// pairs into an int32 sum, exactly.  Channel groups (the quantisation
// groups of ops/conv_q8.py) keep separate int32 sums; each group's sum is
// dequantised as the JAX wrappers do it, int32 -> f32 (round to nearest),
// times the group's f32 column scale, rounded to the output type T, and
// added to the previous groups' total in T's precision, in group order.
// __fmul_rn / __fadd_rn keep nvcc from contracting the two into one FMA.
#pragma once

#include "gather_gemm.cuh"

namespace mrcc {

constexpr int KW = 8;  // int8 words (4 channels each) per stage

// As[kk][r] = word c0 + kk of row src[r] (0 for src[r] < 0 or c0 + kk >= c1).
__device__ __forceinline__ void load_words(int (*As)[TM + 4],
                                           const int* __restrict__ feats,
                                           const int* src, int cw, int c0,
                                           int c1) {
  for (int e = threadIdx.x; e < TM * KW; e += THREADS) {
    const int r = e / KW;
    const int kk = e % KW;
    const int s = src[r];
    const int c = c0 + kk;
    As[kk][r] = (s >= 0 && c < c1)
                    ? __ldg(feats + static_cast<size_t>(s) * cw + c)
                    : 0;
  }
}

// Ws[kk][n] = w[c0 + kk, n0 + n] of one [cw, cout] word slice.
__device__ __forceinline__ void load_w_words(int (*Ws)[TN],
                                             const int* __restrict__ w,
                                             int cout, int c0, int c1,
                                             int n0) {
  for (int e = threadIdx.x; e < KW * TN; e += THREADS) {
    const int kk = e / TN;
    const int n = e % TN;
    const int c = c0 + kk;
    const int col = n0 + n;
    Ws[kk][n] = (c < c1 && col < cout)
                    ? __ldg(w + static_cast<size_t>(c) * cout + col)
                    : 0;
  }
}

__device__ __forceinline__ void dp4a_tile(int (&acc)[4][4],
                                          const int (*As)[TM + 4],
                                          const int (*Ws)[TN]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int kk = 0; kk < KW; ++kk) {
    int a[4];
    int b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Ws[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// res[i][j] (+)= T(f32(acc[i][j]) * srow[i][col]): one group's dequantised
// contribution, srow[i] the column scales of row i's group (and octant).
template <typename T>
__device__ __forceinline__ void dequant_add(float (&res)[4][4],
                                            const int (&acc)[4][4],
                                            const float* const (&srow)[4],
                                            int n0, int cout, bool first) {
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      const float s = col < cout ? __ldg(srow[i] + col) : 0.f;
      const float v =
          round_to<T>(__fmul_rn(static_cast<float>(acc[i][j]), s));
      res[i][j] = first ? v : round_to<T>(__fadd_rn(res[i][j], v));
    }
  }
}

}  // namespace mrcc
