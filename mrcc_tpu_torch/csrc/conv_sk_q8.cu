// B6 — int8 self-keyed k=3 s=1 submanifold sparse convolution.
//
// Replaces: mrcc_tpu/ops/conv_pallas.py::_gather_gemm_call_sk_q8 and the
// integer part of its wrapper gather_gemm_conv_sk_q8.
//
//   out[b, i] = sum_g T( f32( sum_k bit_k(kbits[b, i])
//                             * q[b, j, group g] . Wq[k, group g] ) * m[g] ),
//               key[b, j] == key[b, i] + delta_k,
//
// q the int8 activations, Wq the per-group int8 weights and m[g] the
// group's f32 column scales (ops/conv_q8.py quantises; the sum over groups
// g is taken in the output type T in group order).  Neighbours are K2's:
// a binary search for key + delta_k in the item's sorted keys, gated by bit
// k of the row's bitmap (a border query can alias a real key across the
// packed fields), offset 13 the row itself.
//
// Bound on the card: 2 * hits * Cin * Cout int8 operations against the
// gathered rows (1 byte a channel), the weights and the output; at the
// main path's widths the int8 tensor-core peak puts the bound on bytes.
// Design: K2's tile and search (gather_gemm.cuh::find_key), one launch for
// all channel groups: the neighbour search runs once per CTA, each group
// keeps its own int32 sums and is dequantised on its own (gather_gemm_q8.cuh).
// First version: __dp4a on the CUDA cores, no tensor cores.

#include "gather_gemm_q8.cuh"

namespace {

using namespace mrcc;

constexpr int K3 = 27;

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_sk_q8_kernel(const int* __restrict__ feats, const int* __restrict__ w,
                  const float* __restrict__ scale,
                  const int* __restrict__ key, const int* __restrict__ kbits,
                  T* __restrict__ out, int n, int cw, int cout, int gw,
                  int groups) {
  __shared__ int nbr[K3][TM];
  __shared__ int any_hit[K3];
  __shared__ int As[KW][TM + 4];
  __shared__ int Ws[KW][TN];

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

  float res[4][4] = {};
  const int* fb = feats + static_cast<size_t>(b) * n * cw;
  for (int g = 0; g < groups; ++g) {
    const int c_lo = g * gw;
    const int c_hi = min(c_lo + gw, cw);
    int acc[4][4] = {};
    for (int k = 0; k < K3; ++k) {
      if (!any_hit[k]) continue;  // uniform over the CTA
      const int* wk = w + static_cast<size_t>(k) * cw * cout;
      for (int c0 = c_lo; c0 < c_hi; c0 += KW) {
        load_words(As, fb, nbr[k], cw, c0, c_hi);
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
  store_tile(out + static_cast<size_t>(b) * n * cout, res, m0, n0, n, cout);
}

template <typename T>
int launch(const void* feats, const void* w, const void* scale,
           const int* key, const int* kbits, void* out, int batch, int n,
           int cw, int cout, int gw, int groups, cudaStream_t stream) {
  if (n > 0 && batch > 0 && cout > 0) {
    conv_sk_q8_kernel<T><<<conv_grid(n, cout, batch), THREADS, 0, stream>>>(
        static_cast<const int*>(feats), static_cast<const int*>(w),
        static_cast<const float*>(scale), key, kbits, static_cast<T*>(out), n,
        cw, cout, gw, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats [B, n, cw] int8 words, w [27, cw, cout] int8 words, scale
// [groups, cout] f32, key/kbits [B, n] int32, out [B, n, cout] (T); a group
// is gw words (the last one may be narrower).  All contiguous.  Returns
// cudaGetLastError().
extern "C" int mrcc_conv_sk_q8_f32(const void* feats, const void* w,
                                   const void* scale, const int* key,
                                   const int* kbits, void* out, int batch,
                                   int n, int cw, int cout, int gw,
                                   int groups, cudaStream_t stream) {
  return launch<float>(feats, w, scale, key, kbits, out, batch, n, cw, cout,
                       gw, groups, stream);
}

extern "C" int mrcc_conv_sk_q8_bf16(const void* feats, const void* w,
                                    const void* scale, const int* key,
                                    const int* kbits, void* out, int batch,
                                    int n, int cw, int cout, int gw,
                                    int groups, cudaStream_t stream) {
  return launch<__nv_bfloat16>(feats, w, scale, key, kbits, out, batch, n,
                               cw, cout, gw, groups, stream);
}
