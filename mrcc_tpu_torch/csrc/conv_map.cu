// K3 — gather-GEMMs over explicit kernel maps: the k=2 s=2 down conv, its
// transpose (the up conv), the k=3 s=1 conv over neighbour tables, and the
// generic strided map conv (the sparse ResNet's k=3 s=2 stem and k=3 s=3
// conv5).
//
// Replaces: mrcc_tpu/ops/conv_pallas.py::_gather_gemm_call in its four
// modes: the 8-child down map, the broadcast-k up map (bcast_k), the
// 27-offset k3 table (identity_k = 13) and a [K, B, N_out] map into a
// [B, N_in] table with N_in != N_out (gather_gemm_conv, the Pallas route of
// sparse/conv.py::conv_kernel_map); and _gather_gemm_call_hbm, the same
// function over an HBM-resident table (these kernels read global memory at
// any N).
//
//   down: out[b, p] = sum_{k<8} child_hit[k, b, p]
//                               * feats[b, child_idx[k, b, p]] @ W[k]
//   k3:   out[b, i] = sum_{k<27} nbr_hit[k, b, i]
//                                * feats[b, nbr_idx[k, b, i]] @ W[k]
//   map:  out[b, i] = sum_{k<K} map_hit[k, b, i]
//                               * feats[b, map_idx[k, b, i]] @ W[k], K <= 27
//   up:   out[b, c] = row_ok[b, c]
//                     * feats[b, parent_idx[b, c]] @ W[octant[b, c]]
//
// row_ok is valid & parent_ok: children of parents that overflowed the
// coarse capacity alias slot capacity - 1 and must contribute nothing.
//
// Bound on the card: a down or up hit is one fine row with a parent (about
// 2 a coarse row at level 0 -> 1, 3-4 deeper) and costs 2 * Cin * Cout
// operations against one gathered row.  The decoder's convs (256-512 ->
// 384) are bound by operations, the narrow ones (32 -> 32) by bytes.
// Design (list_mma.cuh): both are a list GEMM over the per-octant hit
// lists of their map (hit_lists.cu: listed once a map and shared with the
// other convs over it, the data cotangents and the dW kernels), so the
// work is exactly the hits; a 64-row tile over the child map would
// multiply all 8 octants for each coarse row.
//   - up: the lists of the fine level's parent map; the GEMM gathers each
//     fine row's parent, multiplies it by W[octant] and stores the fine
//     row of out; zero_rows_kernel clears the rows no list names.
//   - down: the lists of the coarse level's child map; the GEMM stores
//     feats[j] @ W[octant(j)] of every fine row j with a parent into an f32
//     scratch Y, and child_sum_kernel sums each coarse row's children in
//     octant order (bound by bytes) and casts once.
// Two launches a call, no host sync, no float atomics: the same bits for
// the same inputs.  The k3 table conv runs the self-keyed conv's
// tensor-core tile (gather_mma.cuh) with a table load for the key search:
// its neighbour list is the same as K2's (the identity offset's entry is
// the row itself where valid), so the two k3 routes give the same bits,
// forward and backward; over a level's k3 order (k3_order.cu) both run
// the ordered tile, again with the same bits.  The strided map conv runs
// the same tile with a map source of K <= 27 offsets and separate input
// and output row counts: a k=3 s=2 map sends one output row up to 27 input
// rows and one input row to several outputs, so it is no list GEMM (which
// needs each output row in one list at most).

#include "gather_mma.cuh"
#include "k3_sources.cuh"
#include "list_mma.cuh"

namespace {

using namespace mrcc;

// The k3 table conv's row source (k3_sources.cuh) under K3's name.
struct NbrTable : tc::NbrTable {};

// The strided map conv's row source: map_idx / map_hit [taps, B, n] (n the
// output rows), indices into the item's input rows.  Offsets past taps
// name no row.
struct StridedMap {
  const int* idx;
  const uint8_t* hit;
  int batch;
  int taps;

  __device__ __forceinline__ void resolve(int b, int m0, int n,
                                          int* nbr) const {
    for (int e = threadIdx.x; e < tc::K3 * tc::BM; e += tc::THREADS) {
      const int k = e / tc::BM;
      const int row = m0 + e % tc::BM;
      int j = -1;
      if (k < taps && row < n) {
        const size_t o = (static_cast<size_t>(k) * batch + b) * n + row;
        if (hit[o]) j = idx[o];
      }
      nbr[e] = j;
    }
    __syncthreads();
  }
};

}  // namespace

// The list GEMM: out[dst[k][e]] = feats[src[k][e]] @ w[k] for e < count[k].
// feats [rows_in, cin], w [taps, cin, cout] (the feature type), src / dst
// [taps, total] int32, count [taps] int32, out [out_rows, cout]: f32 where
// out_f32, else the feature type (f32 features take f32 out only).  Each
// dst row lies in at most one list.  Returns cudaGetLastError().
extern "C" int mrcc_list_gemm_f32(const void* feats, const void* w,
                                  const int* src, const int* dst,
                                  const int* count, void* out, int taps,
                                  int total, int out_rows, int cin, int cout,
                                  int out_f32, cudaStream_t stream) {
  if (!out_f32) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(lm::launch_list_gemm<float, float>(
      feats, w, src, dst, count, out, taps, total, out_rows, cin, cout,
      stream));
}

extern "C" int mrcc_list_gemm_bf16(const void* feats, const void* w,
                                   const int* src, const int* dst,
                                   const int* count, void* out, int taps,
                                   int total, int out_rows, int cin, int cout,
                                   int out_f32, cudaStream_t stream) {
  return static_cast<int>(
      out_f32 ? lm::launch_list_gemm<__nv_bfloat16, float>(
                    feats, w, src, dst, count, out, taps, total, out_rows,
                    cin, cout, stream)
              : lm::launch_list_gemm<__nv_bfloat16, __nv_bfloat16>(
                    feats, w, src, dst, count, out, taps, total, out_rows,
                    cin, cout, stream));
}

// The down conv's child sum: y [B * n_in, cout] f32 (the list GEMM's rows
// of the fine level), child_idx / child_hit [8, B, n_out], out [B, n_out,
// cout] in the suffix's type.  Returns cudaGetLastError().
extern "C" int mrcc_child_sum_f32(const float* y, const int* child_idx,
                                  const uint8_t* child_hit, void* out,
                                  int batch, int n_in, int n_out, int cout,
                                  cudaStream_t stream) {
  return static_cast<int>(lm::launch_child_sum<float>(
      y, child_idx, child_hit, out, batch, n_in, n_out, cout, stream));
}

extern "C" int mrcc_child_sum_bf16(const float* y, const int* child_idx,
                                   const uint8_t* child_hit, void* out,
                                   int batch, int n_in, int n_out, int cout,
                                   cudaStream_t stream) {
  return static_cast<int>(lm::launch_child_sum<__nv_bfloat16>(
      y, child_idx, child_hit, out, batch, n_in, n_out, cout, stream));
}

// The up conv's zero pass: out [rows, cout] rows whose row_ok is false (or
// whose octant is outside 0..7) set to 0.  Returns cudaGetLastError().
extern "C" int mrcc_zero_rows_f32(const uint8_t* row_ok, const int* octant,
                                  void* out, int rows, int cout,
                                  cudaStream_t stream) {
  return static_cast<int>(
      lm::launch_zero_rows<float>(row_ok, octant, out, rows, cout, stream));
}

extern "C" int mrcc_zero_rows_bf16(const uint8_t* row_ok, const int* octant,
                                   void* out, int rows, int cout,
                                   cudaStream_t stream) {
  return static_cast<int>(lm::launch_zero_rows<__nv_bfloat16>(
      row_ok, octant, out, rows, cout, stream));
}

// k3 table: feats [B, n, cin], w [27, cin, cout], nbr_idx [27, B, n] int32,
// nbr_hit [27, B, n] bool, out [B, n, cout].  lists: int32 scratch of
// B * ceil(n / 64) * (27 * 64 + 28) where cout > 128, else may be null.
// Returns cudaGetLastError().
extern "C" int mrcc_conv_k3map_f32(const void* feats, const void* w,
                                   const int* nbr_idx, const uint8_t* nbr_hit,
                                   int* lists, void* out, int batch, int n,
                                   int cin, int cout, cudaStream_t stream) {
  const cudaError_t err = tc::launch_gather_mma<float>(
      feats, w, NbrTable{{nbr_idx, nbr_hit, batch}}, lists, out, batch, n, cin,
      cout, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int mrcc_conv_k3map_bf16(const void* feats, const void* w,
                                    const int* nbr_idx,
                                    const uint8_t* nbr_hit, int* lists,
                                    void* out, int batch, int n, int cin,
                                    int cout, cudaStream_t stream) {
  const cudaError_t err = tc::launch_gather_mma<__nv_bfloat16>(
      feats, w, NbrTable{{nbr_idx, nbr_hit, batch}}, lists, out, batch, n, cin,
      cout, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// k3 table over the level's k3 order: as mrcc_conv_sk_ordered_*
// (conv_sk.cu).
extern "C" int mrcc_conv_k3map_ordered_f32(const void* feats, const void* w,
                                           const int* lists,
                                           const int* counts, float* part,
                                           int* sync, void* out, int segments,
                                           int batch, int n, int cin,
                                           int cout, cudaStream_t stream) {
  const cudaError_t err = tc::launch_gather_mma_ordered<float, NbrTable>(
      feats, w, lists, counts, static_cast<float*>(out), out, sync, segments,
      batch, n, cin, cout, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int mrcc_conv_k3map_ordered_bf16(const void* feats, const void* w,
                                            const int* lists,
                                            const int* counts, float* part,
                                            int* sync, void* out,
                                            int segments, int batch, int n,
                                            int cin, int cout,
                                            cudaStream_t stream) {
  const cudaError_t err =
      tc::launch_gather_mma_ordered<__nv_bfloat16, NbrTable>(
          feats, w, lists, counts, part, out, sync, segments, batch, n, cin,
          cout, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Strided map: feats [B, n_in, cin], w [taps, cin, cout], map_idx [taps, B,
// n_out] int32 (indices below n_in), map_hit [taps, B, n_out] bool, out [B,
// n_out, cout]; taps <= 27.  lists: int32 scratch of B * ceil(n_out / 64) *
// (27 * 64 + 28) where cout > 128, else may be null.  Returns
// cudaGetLastError().
template <typename T>
static int conv_map(const void* feats, const void* w, const int* map_idx,
                    const uint8_t* map_hit, int* lists, void* out, int batch,
                    int n_in, int n_out, int taps, int cin, int cout,
                    cudaStream_t stream) {
  if (taps < 1 || taps > tc::K3 || n_in < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = tc::launch_gather_mma<T>(
      feats, w, StridedMap{map_idx, map_hit, batch, taps}, lists, out, batch,
      n_out, cin, cout, stream, n_in, taps);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int mrcc_conv_map_f32(const void* feats, const void* w,
                                 const int* map_idx, const uint8_t* map_hit,
                                 int* lists, void* out, int batch, int n_in,
                                 int n_out, int taps, int cin, int cout,
                                 cudaStream_t stream) {
  return conv_map<float>(feats, w, map_idx, map_hit, lists, out, batch, n_in,
                         n_out, taps, cin, cout, stream);
}

extern "C" int mrcc_conv_map_bf16(const void* feats, const void* w,
                                  const int* map_idx, const uint8_t* map_hit,
                                  int* lists, void* out, int batch, int n_in,
                                  int n_out, int taps, int cin, int cout,
                                  cudaStream_t stream) {
  return conv_map<__nv_bfloat16>(feats, w, map_idx, map_hit, lists, out,
                                 batch, n_in, n_out, taps, cin, cout, stream);
}
