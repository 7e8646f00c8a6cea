// Weight gradient of the self-keyed k=3 s=1 conv (K2's backward).
//
// Replaces: mrcc_tpu/ops/conv_pallas.py::_dw_call_sk and its wrapper
// dw_gather_gemm_sk.
//
//   dW[k] = sum_b sum_i bit_k(kbits[b, i]) * [key[b, j] == key[b, i] + delta_k]
//           * feats[b, j]^T (x) g[b, i]                       -> [27, Cin, Cout]
//
// g is the output cotangent, already masked by the level's validity.  The
// neighbour j is K2's: a binary search of key + delta_k in the item's sorted
// key row, gated by the row's offset bit (a border query can alias a real
// key across the packed fields).
//
// Bound on the card: 2 * hits * Cin * Cout FLOPs against the gathered feature
// rows, g and dW in bytes; at the decoder's widths (416 x 384) it is bound by
// operations.  Design (dw_gemm.cuh): one CTA per (k, 64 x 64 block of dW,
// slice of the B x N rows), each resolving its own neighbours (no table in
// device memory), hits compacted in row order, f32 FMA accumulation in
// registers, slices summed by a second kernel in fixed order — deterministic,
// no atomics.  First version: CUDA-core FMA; wgmma is later work.

#include "dw_gemm.cuh"

namespace {

using namespace mrcc;

struct SkSource {
  const int* key;
  const int* kbits;
  int n;

  __device__ __forceinline__ int operator()(int k, int b, int i) const {
    const size_t row = static_cast<size_t>(b) * n + i;
    if (!((kbits[row] >> k) & 1)) return -1;
    if (k == 13) return i;
    const int* krow = key + static_cast<size_t>(b) * n;
    return find_key(krow, n, krow[i] + k3_delta(k));
  }
};

template <typename T>
int launch(const void* feats, const void* g, const int* key, const int* kbits,
           float* part, float* out, int batch, int n, int cin, int cout,
           int slices, cudaStream_t stream) {
  return dw_launch<T>(SkSource{key, kbits, n}, feats, g, part, out, batch, n, n,
                      27, cin, cout, slices, stream);
}

}  // namespace

// feats [B, n, cin], g [B, n, cout] (same dtype), key/kbits [B, n] int32,
// part [slices, 27, cin, cout] f32 (unused when slices == 1),
// out [27, cin, cout] f32; all contiguous.  Returns cudaGetLastError().
extern "C" int mrcc_dw_sk_f32(const void* feats, const void* g, const int* key,
                              const int* kbits, float* part, float* out,
                              int batch, int n, int cin, int cout, int slices,
                              cudaStream_t stream) {
  return launch<float>(feats, g, key, kbits, part, out, batch, n, cin, cout,
                       slices, stream);
}

extern "C" int mrcc_dw_sk_bf16(const void* feats, const void* g, const int* key,
                               const int* kbits, float* part, float* out,
                               int batch, int n, int cin, int cout, int slices,
                               cudaStream_t stream) {
  return launch<__nv_bfloat16>(feats, g, key, kbits, part, out, batch, n, cin,
                               cout, slices, stream);
}
