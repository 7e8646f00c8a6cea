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
// What bounds it on the card: 2 * hits * Cin * Cout operations against the
// gathered rows, the 27 weight slices and the output, so at the main
// path's widths (Cin, Cout 32 .. 416) it is bounded by operations: the
// tensor cores' rate in bf16 (989 TFLOP/s), and in f32 either the CUDA
// cores' 67 TFLOP/s or, as a 3xTF32 split, three TF32 products a term at
// 495 TFLOP/s.  The first version used CUDA-core FMA from f32 shared
// memory (bf16 widened on load, 8 shared loads per 16 FMAs), scalar
// gathers with no overlap of loads and math, and repeated the 27 x 64 key
// searches in every column-tile block: 14x over its bound in f32, 140x in
// bf16.
//
// Design (gather_mma.cuh): tensor cores (mma.sync m16n8k16 bf16,
// m16n8k8 3xTF32 for f32), gathered rows and weight slices by 16-byte
// cp.async into a 3-4 stage ring over the (offset with a hit, channel
// chunk) steps, and one key search per 64-row tile: its 27 x 64
// neighbours over the item's sorted key row (L2-resident; one binary
// search per offset and 8-row run, then a forward walk), resolved by the
// MMA block itself where Cout fits one 128-column tile and else once by a
// resolve kernel for all of the tile's column blocks.  Offsets no row of
// the tile hits are skipped, and the MMAs of 16-row groups without a hit.
// A tile of padding rows hits nothing and only writes zeros.  Over a
// level's k3 order (k3_order.cu) the ordered tile runs instead: each tile
// takes 64 rows that share most of their hits in one segment of the
// offsets, so it runs few stages beyond those its rows' hits need, with
// the same bits.

#include "gather_mma.cuh"
#include "k3_sources.cuh"

namespace {

// K2's name for the key search (conv_sk_q8.cu names its own).
struct KeySearch : mrcc::tc::KeySearch {};

}  // namespace

// feats [B, n, cin], w [27, cin, cout], key/kbits [B, n] int32,
// out [B, n, cout]; all contiguous.  lists: int32 scratch of
// B * ceil(n / 64) * (27 * 64 + 28) where cout > 128, else may be null.
// Returns cudaGetLastError().
extern "C" int mrcc_conv_sk_f32(const void* feats, const void* w,
                                const int* key, const int* kbits, int* lists,
                                void* out, int batch, int n, int cin, int cout,
                                cudaStream_t stream) {
  const cudaError_t err = mrcc::tc::launch_gather_mma<float>(
      feats, w, KeySearch{{key, kbits}}, lists, out, batch, n, cin, cout,
      stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int mrcc_conv_sk_bf16(const void* feats, const void* w,
                                 const int* key, const int* kbits, int* lists,
                                 void* out, int batch, int n, int cin,
                                 int cout, cudaStream_t stream) {
  const cudaError_t err = mrcc::tc::launch_gather_mma<__nv_bfloat16>(
      feats, w, KeySearch{{key, kbits}}, lists, out, batch, n, cin, cout,
      stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The same conv over the level's k3 order: lists [S, B, ceil(n / 64),
// order_list_ints(27 / S)] and counts [S, B] int32 (k3_order.cu), part an
// f32 [B, n, cout] scratch for bf16 (null for f32, which carries its sums
// in out), sync a scratch of 1 + S * B ints.  Cin > 8.  Returns
// cudaGetLastError().
extern "C" int mrcc_conv_sk_ordered_f32(const void* feats, const void* w,
                                        const int* lists, const int* counts,
                                        float* part, int* sync, void* out,
                                        int segments, int batch, int n,
                                        int cin, int cout,
                                        cudaStream_t stream) {
  const cudaError_t err =
      mrcc::tc::launch_gather_mma_ordered<float, KeySearch>(
          feats, w, lists, counts, static_cast<float*>(out), out, sync,
          segments, batch, n, cin, cout, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int mrcc_conv_sk_ordered_bf16(const void* feats, const void* w,
                                         const int* lists, const int* counts,
                                         float* part, int* sync, void* out,
                                         int segments, int batch, int n,
                                         int cin, int cout,
                                         cudaStream_t stream) {
  const cudaError_t err =
      mrcc::tc::launch_gather_mma_ordered<__nv_bfloat16, KeySearch>(
          feats, w, lists, counts, part, out, sync, segments, batch, n, cin,
          cout, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
