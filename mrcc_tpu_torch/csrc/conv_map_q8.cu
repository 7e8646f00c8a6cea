// B7 — int8 gather-GEMM over explicit kernel maps (k=2 s=2 down conv, its
// transpose, and the k=3 s=1 conv over neighbour tables).
//
// Replaces: mrcc_tpu/ops/conv_pallas.py::_gather_gemm_call_q8 in its
// k2-down, broadcast-k up and k3-table (identity_k = 13) modes (the integer
// part of gather_gemm_conv_tiled_q8), and the int8 variant of
// _gather_gemm_call_hbm: these kernels read global memory at any N.
//
//   down: out[b, p] = sum_g T( f32( sum_{k<8} child_hit[k, b, p]
//                 * q[b, child_idx[k, b, p], group g] . Wq[k, group g] )
//                 * m[g] )
//   k3:   the same over the 27-offset table nbr_idx / nbr_hit [27, B, N]
//   up:   out[b, c] = sum_g T( f32( row_ok[b, c]
//                 * q[b, parent_idx[b, c], group g] . Wq[octant[b, c], group g] )
//                 * m[g, octant[b, c]] )
//
// q the int8 activations, Wq the per-group int8 weights, m the f32 column
// scales (ops/conv_q8.py): one per output column for the down conv, one per
// octant and output column for the up conv, whose octants do not share a
// scale.  The sum over groups g is taken in the output type T in group
// order.  row_ok is valid & parent_ok (children of overflowed parents alias
// slot capacity - 1 and contribute nothing).
//
// Bound on the card: 2 * Cin * Cout int8 operations per gathered row
// against the gathered rows, the weights and the output; bytes at the main
// path's shapes.  Design: K3's (conv_map.cu) in int8 words and __dp4a
// (gather_gemm_q8.cuh); the down and k3 maps share one kernel body,
// templated on the offset count, with all channel groups in one launch.  The up conv gathers each parent row once and
// multiplies it by its own octant's weights, with that octant's scales:
// equal to the TPU's wide [C, 8 * Cout] product and octant select, without
// the seven unused octants.  First version: CUDA cores, no tensor cores.

#include "gather_gemm_q8.cuh"

namespace {

using namespace mrcc;

constexpr int K2 = 8;
constexpr int K3 = 27;

// K-offset int8 map conv (K = 8: down, K = 27: k3 table).
template <typename T, int K>
__device__ __forceinline__ void conv_map_q8_body(
    const int* __restrict__ feats, const int* __restrict__ w,
    const float* __restrict__ scale, const int* __restrict__ map_idx,
    const uint8_t* __restrict__ map_hit, T* __restrict__ out, int batch,
    int n_in, int n_out, int cw, int cout, int gw, int groups) {
  __shared__ int src[K][TM];
  __shared__ int any_hit[K];
  __shared__ int As[KW][TM + 4];
  __shared__ int Ws[KW][TN];

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  if (threadIdx.x < K) any_hit[threadIdx.x] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < K * TM; e += THREADS) {
    const int k = e / TM;
    const int r = e % TM;
    const int row = m0 + r;
    int j = -1;
    if (row < n_out) {
      const size_t o = (static_cast<size_t>(k) * batch + b) * n_out + row;
      if (map_hit[o]) j = map_idx[o];
    }
    src[k][r] = j;
    if (j >= 0) any_hit[k] = 1;
  }
  __syncthreads();

  float res[4][4] = {};
  const int* fb = feats + static_cast<size_t>(b) * n_in * cw;
  for (int g = 0; g < groups; ++g) {
    const int c_lo = g * gw;
    const int c_hi = min(c_lo + gw, cw);
    int acc[4][4] = {};
    for (int k = 0; k < K; ++k) {
      if (!any_hit[k]) continue;  // uniform over the CTA
      const int* wk = w + static_cast<size_t>(k) * cw * cout;
      for (int c0 = c_lo; c0 < c_hi; c0 += KW) {
        load_words(As, fb, src[k], cw, c0, c_hi);
        load_w_words(Ws, wk, cout, c0, c_hi, n0);
        __syncthreads();
        dp4a_tile(acc, As, Ws);
        __syncthreads();
      }
    }
    const float* s = scale + static_cast<size_t>(g) * cout;
    const float* const srow[4] = {s, s, s, s};
    dequant_add<T>(res, acc, srow, n0, cout, g == 0);
  }
  store_tile(out + static_cast<size_t>(b) * n_out * cout, res, m0, n0, n_out,
             cout);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_down_q8_kernel(const int* __restrict__ feats, const int* __restrict__ w,
                    const float* __restrict__ scale,
                    const int* __restrict__ child_idx,
                    const uint8_t* __restrict__ child_hit,
                    T* __restrict__ out, int batch, int n_in, int n_out,
                    int cw, int cout, int gw, int groups) {
  conv_map_q8_body<T, K2>(feats, w, scale, child_idx, child_hit, out, batch,
                          n_in, n_out, cw, cout, gw, groups);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_k3map_q8_kernel(const int* __restrict__ feats, const int* __restrict__ w,
                     const float* __restrict__ scale,
                     const int* __restrict__ nbr_idx,
                     const uint8_t* __restrict__ nbr_hit,
                     T* __restrict__ out, int batch, int n, int cw, int cout,
                     int gw, int groups) {
  conv_map_q8_body<T, K3>(feats, w, scale, nbr_idx, nbr_hit, out, batch, n,
                          n, cw, cout, gw, groups);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_up_q8_kernel(const int* __restrict__ feats, const int* __restrict__ w,
                  const float* __restrict__ scale,
                  const int* __restrict__ parent_idx,
                  const uint8_t* __restrict__ row_ok,
                  const int* __restrict__ octant, T* __restrict__ out,
                  int n_in, int n_out, int cw, int cout, int gw,
                  int groups) {
  __shared__ int src[TM];
  __shared__ int oct[TM];
  __shared__ int As[KW][TM + 4];
  __shared__ int Ws[K2][KW][TN];

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  for (int r = threadIdx.x; r < TM; r += THREADS) {
    const int row = m0 + r;
    int j = -1;
    int o = 0;
    if (row < n_out) {
      const size_t at = static_cast<size_t>(b) * n_out + row;
      if (row_ok[at]) {
        j = parent_idx[at];
        o = octant[at];
      }
    }
    src[r] = j;
    oct[r] = o;
  }
  __syncthreads();

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  int my_oct[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) my_oct[i] = oct[ty + 16 * i];

  float res[4][4] = {};
  const int* fb = feats + static_cast<size_t>(b) * n_in * cw;
  for (int g = 0; g < groups; ++g) {
    const int c_lo = g * gw;
    const int c_hi = min(c_lo + gw, cw);
    int acc[4][4] = {};
    for (int c0 = c_lo; c0 < c_hi; c0 += KW) {
      load_words(As, fb, src, cw, c0, c_hi);
      for (int e = threadIdx.x; e < K2 * KW * TN; e += THREADS) {
        const int k = e / (KW * TN);
        const int kk = (e / TN) % KW;
        const int nn = e % TN;
        const int c = c0 + kk;
        const int col = n0 + nn;
        Ws[k][kk][nn] =
            (c < c_hi && col < cout)
                ? __ldg(w + (static_cast<size_t>(k) * cw + c) * cout + col)
                : 0;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KW; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int a = As[kk][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = __dp4a(a, Ws[my_oct[i]][kk][tx + 16 * j], acc[i][j]);
        }
      }
      __syncthreads();
    }
    const float* const srow[4] = {
        scale + (static_cast<size_t>(g) * K2 + my_oct[0]) * cout,
        scale + (static_cast<size_t>(g) * K2 + my_oct[1]) * cout,
        scale + (static_cast<size_t>(g) * K2 + my_oct[2]) * cout,
        scale + (static_cast<size_t>(g) * K2 + my_oct[3]) * cout};
    dequant_add<T>(res, acc, srow, n0, cout, g == 0);
  }
  store_tile(out + static_cast<size_t>(b) * n_out * cout, res, m0, n0, n_out,
             cout);
}

template <typename T>
int launch_down(const void* feats, const void* w, const void* scale,
                const int* child_idx, const uint8_t* child_hit, void* out,
                int batch, int n_in, int n_out, int cw, int cout, int gw,
                int groups, cudaStream_t stream) {
  if (n_out > 0 && batch > 0 && cout > 0) {
    conv_down_q8_kernel<T>
        <<<conv_grid(n_out, cout, batch), THREADS, 0, stream>>>(
            static_cast<const int*>(feats), static_cast<const int*>(w),
            static_cast<const float*>(scale), child_idx, child_hit,
            static_cast<T*>(out), batch, n_in, n_out, cw, cout, gw, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k3map(const void* feats, const void* w, const void* scale,
                 const int* nbr_idx, const uint8_t* nbr_hit, void* out,
                 int batch, int n, int cw, int cout, int gw, int groups,
                 cudaStream_t stream) {
  if (n > 0 && batch > 0 && cout > 0) {
    conv_k3map_q8_kernel<T>
        <<<conv_grid(n, cout, batch), THREADS, 0, stream>>>(
            static_cast<const int*>(feats), static_cast<const int*>(w),
            static_cast<const float*>(scale), nbr_idx, nbr_hit,
            static_cast<T*>(out), batch, n, cw, cout, gw, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_up(const void* feats, const void* w, const void* scale,
              const int* parent_idx, const uint8_t* row_ok,
              const int* octant, void* out, int batch, int n_in, int n_out,
              int cw, int cout, int gw, int groups, cudaStream_t stream) {
  if (n_out > 0 && batch > 0 && cout > 0) {
    conv_up_q8_kernel<T><<<conv_grid(n_out, cout, batch), THREADS, 0,
                           stream>>>(
        static_cast<const int*>(feats), static_cast<const int*>(w),
        static_cast<const float*>(scale), parent_idx, row_ok, octant,
        static_cast<T*>(out), n_in, n_out, cw, cout, gw, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// down: feats [B, n_in, cw] int8 words (fine level), w [8, cw, cout] int8
// words, scale [groups, cout] f32, child_idx [8, B, n_out] int32,
// child_hit [8, B, n_out] bool, out [B, n_out, cout] (coarse level).
// Returns cudaGetLastError().
extern "C" int mrcc_conv_down_q8_f32(const void* feats, const void* w,
                                     const void* scale, const int* child_idx,
                                     const uint8_t* child_hit, void* out,
                                     int batch, int n_in, int n_out, int cw,
                                     int cout, int gw, int groups,
                                     cudaStream_t stream) {
  return launch_down<float>(feats, w, scale, child_idx, child_hit, out, batch,
                            n_in, n_out, cw, cout, gw, groups, stream);
}

extern "C" int mrcc_conv_down_q8_bf16(const void* feats, const void* w,
                                      const void* scale, const int* child_idx,
                                      const uint8_t* child_hit, void* out,
                                      int batch, int n_in, int n_out, int cw,
                                      int cout, int gw, int groups,
                                      cudaStream_t stream) {
  return launch_down<__nv_bfloat16>(feats, w, scale, child_idx, child_hit,
                                    out, batch, n_in, n_out, cw, cout, gw,
                                    groups, stream);
}

// k3 table: feats [B, n, cw] int8 words, w [27, cw, cout] int8 words,
// scale [groups, cout] f32, nbr_idx [27, B, n] int32, nbr_hit [27, B, n]
// bool, out [B, n, cout].  Returns cudaGetLastError().
extern "C" int mrcc_conv_k3map_q8_f32(const void* feats, const void* w,
                                      const void* scale, const int* nbr_idx,
                                      const uint8_t* nbr_hit, void* out,
                                      int batch, int n, int cw, int cout,
                                      int gw, int groups,
                                      cudaStream_t stream) {
  return launch_k3map<float>(feats, w, scale, nbr_idx, nbr_hit, out, batch, n,
                             cw, cout, gw, groups, stream);
}

extern "C" int mrcc_conv_k3map_q8_bf16(const void* feats, const void* w,
                                       const void* scale, const int* nbr_idx,
                                       const uint8_t* nbr_hit, void* out,
                                       int batch, int n, int cw, int cout,
                                       int gw, int groups,
                                       cudaStream_t stream) {
  return launch_k3map<__nv_bfloat16>(feats, w, scale, nbr_idx, nbr_hit, out,
                                     batch, n, cw, cout, gw, groups, stream);
}

// up: feats [B, n_in, cw] int8 words (coarse level), w [8, cw, cout] int8
// words, scale [groups, 8, cout] f32, parent_idx/octant [B, n_out] int32,
// row_ok [B, n_out] bool, out [B, n_out, cout] (fine level).  Returns
// cudaGetLastError().
extern "C" int mrcc_conv_up_q8_f32(const void* feats, const void* w,
                                   const void* scale, const int* parent_idx,
                                   const uint8_t* row_ok, const int* octant,
                                   void* out, int batch, int n_in, int n_out,
                                   int cw, int cout, int gw, int groups,
                                   cudaStream_t stream) {
  return launch_up<float>(feats, w, scale, parent_idx, row_ok, octant, out,
                          batch, n_in, n_out, cw, cout, gw, groups, stream);
}

extern "C" int mrcc_conv_up_q8_bf16(const void* feats, const void* w,
                                    const void* scale, const int* parent_idx,
                                    const uint8_t* row_ok, const int* octant,
                                    void* out, int batch, int n_in,
                                    int n_out, int cw, int cout, int gw,
                                    int groups, cudaStream_t stream) {
  return launch_up<__nv_bfloat16>(feats, w, scale, parent_idx, row_ok,
                                  octant, out, batch, n_in, n_out, cw, cout,
                                  gw, groups, stream);
}
