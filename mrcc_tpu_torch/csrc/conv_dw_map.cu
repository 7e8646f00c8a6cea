// Weight gradients of K3's convs over explicit maps: the k=2 s=2 down
// conv, its transpose, and the k=3 s=1 conv over a level's neighbour
// tables.
//
// Replaces: mrcc_tpu/ops/conv_pallas.py::_dw_call and its wrapper
// dw_gather_gemm, over the down (8-child) map, the broadcast-k up map and
// the 27-offset rank tables (the k3-table mode, the weight cotangent of
// pallas_conv_op("k3", ...)).
//
//   down:  dW[k] = sum_{b,p} child_hit[k, b, p] * feats[b, child_idx[k, b, p]]^T (x) g[b, p]
//   up:    dW[k] = sum_{b,c} row_ok[b, c] * [octant[b, c] == k]
//                  * feats[b, parent_idx[b, c]]^T (x) g[b, c]
//   k3map: dW[k] = sum_{b,i} nbr_hit[k, b, i] * feats[b, nbr_idx[k, b, i]]^T (x) g[b, i]
//
// feats is the conv's input level (fine for down, coarse for up, the
// level itself for k3map), g its output cotangent masked by the output
// level's validity.  row_ok is valid & parent_ok: children of parents that
// overflowed the coarse capacity alias slot capacity - 1 and contribute
// nothing.
//
// Bound on the card: each hit row costs 2 * Cin * Cout FLOPs against one
// gathered feature row and one g row; the wide convs of the decoder
// (256/384 channels) are bound by operations, the narrow ones (the stem,
// the down convs) by bytes.  Design: dw_gemm.cuh (per-offset hit lists
// built once, a tensor-core gather-GEMM per (offset, dW tile, slice of the
// list), slices summed in a fixed order).  The TPU kernel's one-hot window
// gathers, lane packing and 128-aligned windows are VMEM workarounds with
// no counterpart here: a table entry is a plain row index.

#include "dw_gemm.cuh"

namespace {

using namespace mrcc;

constexpr int K2 = 8;
constexpr int K3 = 27;

// The dW kernels' names for the maps of hit_lists.cuh (K3's convs list the
// same maps under names of their own, conv_map.cu).
struct DownSource : hitlist::ChildMap {};
struct UpSource : hitlist::ParentMap {};

struct TableSource {
  const int* nbr_idx;
  const uint8_t* nbr_hit;
  int batch;
  int n;

  __device__ __forceinline__ int operator()(int k, int b, int i) const {
    const size_t o = (static_cast<size_t>(k) * batch + b) * n + i;
    return nbr_hit[o] ? nbr_idx[o] : -1;
  }
};

}  // namespace

// Scratch of every entry point: lists [2, K, B * n_out] int32, status
// [K * ceil(B * n_out / 2048) + 1] u64, count [K] int32, part [slots,
// cin, cout] f32 (unused when slots == K); out [K, cin, cout] f32.  The
// *_lists entry points build the lists alone.  Each returns
// cudaGetLastError().

// down: feats [B, n_in, cin] (fine), g [B, n_out, cout] (coarse),
// child_idx [8, B, n_out] int32, child_hit [8, B, n_out] bool.
#define DW_DOWN(SUFFIX, T)                                                    \
  extern "C" int mrcc_dw_down_##SUFFIX(                                      \
      const void* feats, const void* g, const int* child_idx,                \
      const uint8_t* child_hit, int* lists, unsigned long long* status,      \
      int* count, float* part, float* out, int batch, int n_in, int n_out,   \
      int cin, int cout, int slots, cudaStream_t stream) {                  \
    return mrcc::dw_launch<T>(                                                \
        DownSource{{child_idx, child_hit, batch, n_out}}, feats, g, lists,   \
        status, count, part, out, batch, n_in, n_out, K2, cin, cout, slots, \
        stream);                                                             \
  }
DW_DOWN(f32, float)
DW_DOWN(bf16, __nv_bfloat16)

extern "C" int mrcc_dw_down_lists(const int* child_idx,
                                  const uint8_t* child_hit, int* lists,
                                  unsigned long long* status, int* count,
                                  int batch, int n_in, int n_out,
                                  cudaStream_t stream) {
  return mrcc::hitlist::build_lists(
      DownSource{{child_idx, child_hit, batch, n_out}}, lists, status, count,
      batch, n_in, n_out, K2, stream);
}

// up: feats [B, n_in, cin] (coarse), g [B, n_out, cout] (fine),
// parent_idx/octant [B, n_out] int32, row_ok [B, n_out] bool.
#define DW_UP(SUFFIX, T)                                                      \
  extern "C" int mrcc_dw_up_##SUFFIX(                                        \
      const void* feats, const void* g, const int* parent_idx,               \
      const uint8_t* row_ok, const int* octant, int* lists,                  \
      unsigned long long* status, int* count, float* part, float* out,       \
      int batch, int n_in, int n_out, int cin, int cout, int slots,         \
      cudaStream_t stream) {                                                 \
    return mrcc::dw_launch<T>(                                                \
        UpSource{{parent_idx, row_ok, octant, n_out}}, feats, g, lists,      \
        status, count, part, out, batch, n_in, n_out, K2, cin, cout, slots, \
        stream);                                                             \
  }
DW_UP(f32, float)
DW_UP(bf16, __nv_bfloat16)

extern "C" int mrcc_dw_up_lists(const int* parent_idx, const uint8_t* row_ok,
                                const int* octant, int* lists,
                                unsigned long long* status, int* count,
                                int batch, int n_in, int n_out,
                                cudaStream_t stream) {
  return mrcc::hitlist::build_lists(
      UpSource{{parent_idx, row_ok, octant, n_out}}, lists, status, count,
      batch, n_in, n_out, K2, stream);
}

// k3map: feats [B, n, cin], g [B, n, cout] (the same level),
// nbr_idx [27, B, n] int32, nbr_hit [27, B, n] bool.
#define DW_K3MAP(SUFFIX, T)                                                   \
  extern "C" int mrcc_dw_k3map_##SUFFIX(                                     \
      const void* feats, const void* g, const int* nbr_idx,                  \
      const uint8_t* nbr_hit, int* lists, unsigned long long* status,        \
      int* count, float* part, float* out, int batch, int n, int cin,        \
      int cout, int slots, cudaStream_t stream) {                           \
    return mrcc::dw_launch<T>(                                                \
        TableSource{nbr_idx, nbr_hit, batch, n}, feats, g, lists, status,    \
        count, part, out, batch, n, n, K3, cin, cout, slots, stream);       \
  }
DW_K3MAP(f32, float)
DW_K3MAP(bf16, __nv_bfloat16)

extern "C" int mrcc_dw_k3map_lists(const int* nbr_idx, const uint8_t* nbr_hit,
                                   int* lists, unsigned long long* status,
                                   int* count, int batch, int n,
                                   cudaStream_t stream) {
  return mrcc::hitlist::build_lists(TableSource{nbr_idx, nbr_hit, batch, n},
                                    lists, status, count, batch, n, n, K3,
                                    stream);
}
