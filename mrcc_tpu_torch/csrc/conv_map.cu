// K3 — gather-GEMM over explicit kernel maps: the k=2 s=2 down conv, its
// transpose, and the k=3 s=1 conv over neighbour tables.
//
// Replaces: mrcc_tpu/ops/conv_pallas.py::_gather_gemm_call in its three
// modes: the 8-child down map, the broadcast-k up map (bcast_k), and the
// 27-offset k3 table (identity_k = 13); and _gather_gemm_call_hbm, the same
// function over an HBM-resident table (these kernels read global memory at
// any N).
//
//   down: out[b, p] = sum_{k<8} child_hit[k, b, p] * feats[b, child_idx[k, b, p]] @ W[k]
//   k3:   out[b, i] = sum_{k<27} nbr_hit[k, b, i] * feats[b, nbr_idx[k, b, i]] @ W[k]
//   up:   out[b, c] = row_ok[b, c] * feats[b, parent_idx[b, c]] @ W[octant[b, c]]
//
// row_ok is valid & parent_ok: children of parents that overflowed the
// coarse capacity alias slot capacity - 1 and must contribute nothing.  The
// up conv is ONE gather per output row with the weight slice picked by the
// row's octant, not eight masked passes.
//
// Bound on the card: the down conv reads 8 child rows of Cin per parent,
// the k3 conv up to 27 neighbour rows per row, the up conv one parent row
// per child; all do 2 * Cin * Cout FLOPs per gathered row (operations at
// the k3 conv's decoder widths, bytes at narrow ones).  Design: one kernel
// for the down and k3 maps, templated on the offset count; the maps are
// read once per CTA into shared memory (27 x 64 ints for k3), offsets no
// row of the tile hits are skipped, and the identity offset reads the
// table like any other (its entry is the row itself where valid);
// gathered rows stage through shared memory in f32 and accumulate with FMA
// (gather_gemm.cuh).  The up conv keeps all eight weight slices of a channel
// stage in shared memory (8 x 8 x 64 f32 = 16 KB) so that each output row
// multiplies by its own octant's slice.  First version: CUDA-core FMA.

#include "gather_gemm.cuh"

namespace {

using namespace mrcc;

constexpr int K2 = 8;
constexpr int K3 = 27;
constexpr int KC_DOWN = 16;
constexpr int KC_UP = 8;

// K-offset map conv (K = 8: down, K = 27: k3 table); named conv_down_kernel
// for K = 8 and conv_k3map_kernel for K = 27 in profiles.
template <typename T, int K>
__device__ __forceinline__ void conv_map_body(
    const T* __restrict__ feats, const T* __restrict__ w,
    const int* __restrict__ map_idx, const uint8_t* __restrict__ map_hit,
    T* __restrict__ out, int batch, int n_in, int n_out, int cin, int cout) {
  __shared__ int src[K][TM];
  __shared__ int any_hit[K];
  __shared__ float As[KC_DOWN][TM + 4];
  __shared__ float Ws[KC_DOWN][TN];

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

  float acc[4][4] = {};
  const T* fb = feats + static_cast<size_t>(b) * n_in * cin;
  for (int k = 0; k < K; ++k) {
    if (!any_hit[k]) continue;  // uniform over the CTA
    const T* wk = w + static_cast<size_t>(k) * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += KC_DOWN) {
      load_rows<KC_DOWN>(As, fb, src[k], cin, c0);
      load_w<KC_DOWN>(Ws, wk, cin, cout, c0, n0);
      __syncthreads();
      fma_tile<KC_DOWN>(acc, As, Ws);
      __syncthreads();
    }
  }
  store_tile(out + static_cast<size_t>(b) * n_out * cout, acc, m0, n0, n_out,
             cout);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_down_kernel(const T* __restrict__ feats, const T* __restrict__ w,
                 const int* __restrict__ child_idx,
                 const uint8_t* __restrict__ child_hit, T* __restrict__ out,
                 int batch, int n_in, int n_out, int cin, int cout) {
  conv_map_body<T, K2>(feats, w, child_idx, child_hit, out, batch, n_in,
                       n_out, cin, cout);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_k3map_kernel(const T* __restrict__ feats, const T* __restrict__ w,
                  const int* __restrict__ nbr_idx,
                  const uint8_t* __restrict__ nbr_hit, T* __restrict__ out,
                  int batch, int n, int cin, int cout) {
  conv_map_body<T, K3>(feats, w, nbr_idx, nbr_hit, out, batch, n, n, cin,
                       cout);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_up_kernel(const T* __restrict__ feats, const T* __restrict__ w,
               const int* __restrict__ parent_idx,
               const uint8_t* __restrict__ row_ok,
               const int* __restrict__ octant, T* __restrict__ out, int n_in,
               int n_out, int cin, int cout) {
  __shared__ int src[TM];
  __shared__ int oct[TM];
  __shared__ float As[KC_UP][TM + 4];
  __shared__ float Ws[K2][KC_UP][TN];

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

  float acc[4][4] = {};
  const T* fb = feats + static_cast<size_t>(b) * n_in * cin;
  for (int c0 = 0; c0 < cin; c0 += KC_UP) {
    load_rows<KC_UP>(As, fb, src, cin, c0);
    for (int e = threadIdx.x; e < K2 * KC_UP * TN; e += THREADS) {
      const int k = e / (KC_UP * TN);
      const int kk = (e / TN) % KC_UP;
      const int nn = e % TN;
      const int c = c0 + kk;
      const int col = n0 + nn;
      Ws[k][kk][nn] =
          (c < cin && col < cout)
              ? to_f32(w[(static_cast<size_t>(k) * cin + c) * cout + col])
              : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC_UP; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(a, Ws[my_oct[i]][kk][tx + 16 * j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  store_tile(out + static_cast<size_t>(b) * n_out * cout, acc, m0, n0, n_out,
             cout);
}

template <typename T>
int launch_down(const void* feats, const void* w, const int* child_idx,
                const uint8_t* child_hit, void* out, int batch, int n_in,
                int n_out, int cin, int cout, cudaStream_t stream) {
  if (n_out > 0 && batch > 0 && cout > 0) {
    conv_down_kernel<T><<<conv_grid(n_out, cout, batch), THREADS, 0, stream>>>(
        static_cast<const T*>(feats), static_cast<const T*>(w), child_idx,
        child_hit, static_cast<T*>(out), batch, n_in, n_out, cin, cout);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k3map(const void* feats, const void* w, const int* nbr_idx,
                 const uint8_t* nbr_hit, void* out, int batch, int n, int cin,
                 int cout, cudaStream_t stream) {
  if (n > 0 && batch > 0 && cout > 0) {
    conv_k3map_kernel<T><<<conv_grid(n, cout, batch), THREADS, 0, stream>>>(
        static_cast<const T*>(feats), static_cast<const T*>(w), nbr_idx,
        nbr_hit, static_cast<T*>(out), batch, n, cin, cout);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_up(const void* feats, const void* w, const int* parent_idx,
              const uint8_t* row_ok, const int* octant, void* out, int batch,
              int n_in, int n_out, int cin, int cout, cudaStream_t stream) {
  if (n_out > 0 && batch > 0 && cout > 0) {
    conv_up_kernel<T><<<conv_grid(n_out, cout, batch), THREADS, 0, stream>>>(
        static_cast<const T*>(feats), static_cast<const T*>(w), parent_idx,
        row_ok, octant, static_cast<T*>(out), n_in, n_out, cin, cout);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// down: feats [B, n_in, cin] (fine level), w [8, cin, cout],
// child_idx [8, B, n_out] int32, child_hit [8, B, n_out] bool,
// out [B, n_out, cout] (coarse level).  Returns cudaGetLastError().
extern "C" int mrcc_conv_down_f32(const void* feats, const void* w,
                                  const int* child_idx, const uint8_t* child_hit,
                                  void* out, int batch, int n_in, int n_out,
                                  int cin, int cout, cudaStream_t stream) {
  return launch_down<float>(feats, w, child_idx, child_hit, out, batch, n_in,
                            n_out, cin, cout, stream);
}

extern "C" int mrcc_conv_down_bf16(const void* feats, const void* w,
                                   const int* child_idx,
                                   const uint8_t* child_hit, void* out,
                                   int batch, int n_in, int n_out, int cin,
                                   int cout, cudaStream_t stream) {
  return launch_down<__nv_bfloat16>(feats, w, child_idx, child_hit, out, batch,
                                    n_in, n_out, cin, cout, stream);
}

// k3 table: feats [B, n, cin], w [27, cin, cout], nbr_idx [27, B, n] int32,
// nbr_hit [27, B, n] bool, out [B, n, cout].  Returns cudaGetLastError().
extern "C" int mrcc_conv_k3map_f32(const void* feats, const void* w,
                                   const int* nbr_idx, const uint8_t* nbr_hit,
                                   void* out, int batch, int n, int cin,
                                   int cout, cudaStream_t stream) {
  return launch_k3map<float>(feats, w, nbr_idx, nbr_hit, out, batch, n, cin,
                             cout, stream);
}

extern "C" int mrcc_conv_k3map_bf16(const void* feats, const void* w,
                                    const int* nbr_idx, const uint8_t* nbr_hit,
                                    void* out, int batch, int n, int cin,
                                    int cout, cudaStream_t stream) {
  return launch_k3map<__nv_bfloat16>(feats, w, nbr_idx, nbr_hit, out, batch,
                                     n, cin, cout, stream);
}

// up: feats [B, n_in, cin] (coarse level), w [8, cin, cout],
// parent_idx/octant [B, n_out] int32, row_ok [B, n_out] bool,
// out [B, n_out, cout] (fine level).  Returns cudaGetLastError().
extern "C" int mrcc_conv_up_f32(const void* feats, const void* w,
                                const int* parent_idx, const uint8_t* row_ok,
                                const int* octant, void* out, int batch,
                                int n_in, int n_out, int cin, int cout,
                                cudaStream_t stream) {
  return launch_up<float>(feats, w, parent_idx, row_ok, octant, out, batch,
                          n_in, n_out, cin, cout, stream);
}

extern "C" int mrcc_conv_up_bf16(const void* feats, const void* w,
                                 const int* parent_idx, const uint8_t* row_ok,
                                 const int* octant, void* out, int batch,
                                 int n_in, int n_out, int cin, int cout,
                                 cudaStream_t stream) {
  return launch_up<__nv_bfloat16>(feats, w, parent_idx, row_ok, octant, out,
                                  batch, n_in, n_out, cin, cout, stream);
}
