// K2 — self-keyed k=3 s=1 submanifold sparse convolution.
//
// Replaces: mrcc_tpu/ops/conv_pallas.py::_gather_gemm_call_sk and its
// wrapper gather_gemm_conv_sk.
//
//   out[b, i] = sum_k bit_k(kbits[b, i]) * feats[b, j] @ W[k],
//               key[b, j] == key[b, i] + delta_k,
//
// with delta_k the packed key delta of K3_OFFSETS[k] (x slowest, z fastest;
// k = 13 is the row itself).  A missing neighbour contributes nothing.  The
// bitmap is not an optimisation: a border query key[i] + delta_k can alias
// a real key across the packed 10-bit fields, so a key match without its
// bit is a false neighbour.  Rows with kbits == 0 (padding) come out 0.
//
// Bound on the card: every output row reads up to 27 input rows of Cin
// values, so at the main path's widths (Cin, Cout <= 384) the work is
// 2 * hits * Cin * Cout FLOPs against (N * Cin + 27 * Cin * Cout + N * Cout)
// elements of traffic.  Design: no neighbour tables in device memory.  A
// CTA resolves its own 27 x 64 neighbours by binary search over the item's
// sorted key row (L2-resident: 49 KB at 12544 rows), skips offsets no row
// of its tile hits, gathers the hit rows into shared memory in 16-channel
// stages and accumulates in f32 with FMA (gather_gemm.cuh).  First
// version: CUDA-core FMA, no tensor cores; wgmma and TMA are later work.

#include "gather_gemm.cuh"

namespace {

using namespace mrcc;

constexpr int K3 = 27;
constexpr int KC = 16;

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_sk_kernel(const T* __restrict__ feats, const T* __restrict__ w,
               const int* __restrict__ key, const int* __restrict__ kbits,
               T* __restrict__ out, int n, int cin, int cout) {
  __shared__ int nbr[K3][TM];
  __shared__ int any_hit[K3];
  __shared__ float As[KC][TM + 4];
  __shared__ float Ws[KC][TN];

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int* krow = key + static_cast<size_t>(b) * n;
  const int* brow = kbits + static_cast<size_t>(b) * n;

  if (threadIdx.x < K3) any_hit[threadIdx.x] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < K3 * TM; e += THREADS) {
    const int k = e / TM;
    const int r = e % TM;
    const int row = m0 + r;
    int j = -1;
    if (row < n && ((brow[row] >> k) & 1)) {
      j = k == 13 ? row : find_key(krow, n, krow[row] + k3_delta(k));
    }
    nbr[k][r] = j;
    if (j >= 0) any_hit[k] = 1;
  }
  __syncthreads();

  float acc[4][4] = {};
  const T* fb = feats + static_cast<size_t>(b) * n * cin;
  for (int k = 0; k < K3; ++k) {
    if (!any_hit[k]) continue;  // uniform over the CTA
    const T* wk = w + static_cast<size_t>(k) * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += KC) {
      load_rows<KC>(As, fb, nbr[k], cin, c0);
      load_w<KC>(Ws, wk, cin, cout, c0, n0);
      __syncthreads();
      fma_tile<KC>(acc, As, Ws);
      __syncthreads();
    }
  }
  store_tile(out + static_cast<size_t>(b) * n * cout, acc, m0, n0, n, cout);
}

template <typename T>
int launch(const void* feats, const void* w, const int* key, const int* kbits,
           void* out, int batch, int n, int cin, int cout,
           cudaStream_t stream) {
  if (n > 0 && batch > 0 && cout > 0) {
    conv_sk_kernel<T><<<conv_grid(n, cout, batch), THREADS, 0, stream>>>(
        static_cast<const T*>(feats), static_cast<const T*>(w), key, kbits,
        static_cast<T*>(out), n, cin, cout);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats [B, n, cin], w [27, cin, cout], key/kbits [B, n] int32,
// out [B, n, cout]; all contiguous.  Returns cudaGetLastError().
extern "C" int mrcc_conv_sk_f32(const void* feats, const void* w,
                                const int* key, const int* kbits, void* out,
                                int batch, int n, int cin, int cout,
                                cudaStream_t stream) {
  return launch<float>(feats, w, key, kbits, out, batch, n, cin, cout, stream);
}

extern "C" int mrcc_conv_sk_bf16(const void* feats, const void* w,
                                 const int* key, const int* kbits, void* out,
                                 int batch, int n, int cin, int cout,
                                 cudaStream_t stream) {
  return launch<__nv_bfloat16>(feats, w, key, kbits, out, batch, n, cin, cout,
                               stream);
}
