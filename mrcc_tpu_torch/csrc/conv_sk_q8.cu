// B6 — int8 self-keyed k=3 s=1 submanifold sparse convolution.
//
// Replaces: mrcc_tpu/ops/conv_pallas.py::_gather_gemm_call_sk_q8 and its
// wrapper gather_gemm_conv_sk_q8, the quantisation included.
//
//   out[b, i] = sum_g T( f32( sum_k bit_k(kbits[b, i])
//                             * q[b, j, group g] . Wq[k, group g] ) * m[g] ),
//               key[b, j] == key[b, i] + delta_k,
//
// q the int8 activations, Wq the per-group int8 weights and m[g] the
// group's f32 column scales (q8_quantize.cuh; the sum over groups g is
// taken in the output type T in group order).  Neighbours are K2's: the
// key search of k3_sources.cuh, gated by bit k of the row's bitmap (a
// border query can alias a real key across the packed fields), offset 13
// the row itself.
//
// Bound on the card: 2 * hits * Cin * Cout int8 operations (1,979 TOP/s)
// against the gathered rows (1 byte a channel), the weights and the
// output; bytes at the main path's widths.  int8 only pays on the tensor
// cores (CUDA-core 4-way dot products ran 2.5-5x slower than the bf16 K2
// at the same shapes), and only if the key search and the gathers are not
// repeated per column tile.  Design: K2's tile and row tile resolve on
// int8 tensor cores (q8_mma.cuh: mma.sync m16n8k32, a cp.async ring over
// (group, offset with a hit, 128-channel chunk), each group dequantised as
// it ends).  The quantisation is q8_quantize.cuh's pass (exported by
// conv_map_q8.cu).

#include "k3_sources.cuh"
#include "q8_mma.cuh"

namespace {

using namespace mrcc;

// B6's name for the key search (K2 names its own, conv_sk.cu).
struct Q8Keys : tc::KeySearch {};

template <typename T>
int conv(const void* q, const void* wq, const float* scale, const int* key,
         const int* kbits, int* lists, void* out, int batch, int n, int cin,
         int cpad, int cout, int gw, int ng, cudaStream_t stream) {
  const cudaError_t err = q8::launch_gather_mma<T>(
      q, wq, scale, Q8Keys{{key, kbits}}, lists, out, batch, n,
      q8::Groups{cin, cpad, gw, ng}, cout, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// q [B, n, cpad] int8, wq [27, cout, cpad] int8, scale [ng, cout] f32,
// key/kbits [B, n] int32, out [B, n, cout] (T); groups of gw channels, the
// last ending at cin.  lists: int32 scratch of B * ceil(n / 64) * (27 * 64
// + 28) where cout > 128, else may be null.  Returns cudaGetLastError().
extern "C" int mrcc_conv_sk_q8_f32(const void* q, const void* wq,
                                   const float* scale, const int* key,
                                   const int* kbits, int* lists, void* out,
                                   int batch, int n, int cin, int cpad,
                                   int cout, int gw, int ng,
                                   cudaStream_t stream) {
  return conv<float>(q, wq, scale, key, kbits, lists, out, batch, n, cin,
                     cpad, cout, gw, ng, stream);
}

extern "C" int mrcc_conv_sk_q8_bf16(const void* q, const void* wq,
                                    const float* scale, const int* key,
                                    const int* kbits, int* lists, void* out,
                                    int batch, int n, int cin, int cpad,
                                    int cout, int gw, int ng,
                                    cudaStream_t stream) {
  return conv<__nv_bfloat16>(q, wq, scale, key, kbits, lists, out, batch, n,
                             cin, cpad, cout, gw, ng, stream);
}
