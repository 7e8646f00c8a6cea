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
// Bound on the card: 2 * hits * Cin * Cout operations against the gathered
// feature rows, g and dW in bytes; at the decoder's widths (416 x 384) it
// is bound by operations.  Design (dw_gemm.cuh): each (offset, row) pair is
// searched once into per-offset hit lists (hit_lists.cuh), then a
// tensor-core gather-GEMM (bf16 mma.sync, f32 as 3xTF32) per (offset, dW
// tile, slice of the list), slices summed in a fixed order: deterministic,
// no atomics on floats.  SkSource and the k3 tables of the same level give
// the same lists, so dw_sk and dw_k3map give the same bits.

#include "gather_gemm.cuh"  // find_key, k3_delta
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

// The list stage's rows side by side: one branchless binary search a row
// (lower bound of key + delta_k in the item's key row), all ITEMS rows of
// a thread stepping together so that their loads overlap.
__device__ __forceinline__ void resolve(const SkSource& src, int k,
                                        const int (&b)[hitlist::ITEMS],
                                        const int (&i)[hitlist::ITEMS],
                                        int (&j)[hitlist::ITEMS]) {
  constexpr int N = hitlist::ITEMS;
  const int* krow[N];
  int q[N], pos[N];
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int bb = b[it] < 0 ? 0 : b[it];
    krow[it] = src.key + static_cast<size_t>(bb) * src.n;
    q[it] = __ldg(krow[it] + i[it]) + k3_delta(k);
    pos[it] = 0;
  }
  for (int len = src.n; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int it = 0; it < N; ++it)
      pos[it] += __ldg(krow[it] + pos[it] + half - 1) < q[it] ? half : 0;
    len -= half;
  }
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const bool on = b[it] >= 0 &&
                    ((__ldg(src.kbits + static_cast<size_t>(b[it]) * src.n +
                            i[it]) >> k) & 1);
    const int lb = pos[it] + (__ldg(krow[it] + pos[it]) < q[it]);
    j[it] = !on ? -1
            : k == 13 ? i[it]
            : (lb < src.n && __ldg(krow[it] + lb) == q[it]) ? lb
                                                            : -1;
  }
}

template <typename T>
int launch(const void* feats, const void* g, const int* key, const int* kbits,
           int* lists, unsigned long long* status, int* count, float* part,
           float* out, int batch, int n, int cin, int cout, int slots,
           cudaStream_t stream) {
  return dw_launch<T>(SkSource{key, kbits, n}, feats, g, lists, status, count,
                      part, out, batch, n, n, 27, cin, cout, slots, stream);
}

}  // namespace

// feats [B, n, cin], g [B, n, cout] (same dtype), key/kbits [B, n] int32,
// lists [2, 27, B * n] int32, status [27 * ceil(B * n / 2048) + 1] u64,
// count [27] int32, part [slots, cin, cout] f32 (unused when slots ==
// 27), out [27, cin, cout] f32; all contiguous.  Returns
// cudaGetLastError().
extern "C" int mrcc_dw_sk_f32(const void* feats, const void* g, const int* key,
                              const int* kbits, int* lists,
                              unsigned long long* status, int* count,
                              float* part, float* out, int batch, int n,
                              int cin, int cout, int slots,
                              cudaStream_t stream) {
  return launch<float>(feats, g, key, kbits, lists, status, count, part, out,
                       batch, n, cin, cout, slots, stream);
}

extern "C" int mrcc_dw_sk_bf16(const void* feats, const void* g,
                               const int* key, const int* kbits, int* lists,
                               unsigned long long* status, int* count,
                               float* part, float* out, int batch, int n,
                               int cin, int cout, int slots,
                               cudaStream_t stream) {
  return launch<__nv_bfloat16>(feats, g, key, kbits, lists, status, count,
                               part, out, batch, n, cin, cout, slots, stream);
}

// The hit lists alone: lists, status and count as above.
extern "C" int mrcc_dw_sk_lists(const int* key, const int* kbits, int* lists,
                                unsigned long long* status, int* count,
                                int batch, int n, cudaStream_t stream) {
  return mrcc::hitlist::build_lists(SkSource{key, kbits, n}, lists, status,
                                    count, batch, n, n, 27, stream);
}
