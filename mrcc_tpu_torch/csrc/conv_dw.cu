// Weight gradients of K2's and K3's convs over a map's hit lists: the
// self-keyed k=3 s=1 conv, the k=3 s=1 conv over a level's neighbour
// tables, the k=2 s=2 down conv and its transpose.
//
// Replaces: mrcc_tpu/ops/conv_pallas.py::_dw_call_sk and its wrapper
// dw_gather_gemm_sk; _dw_call and its wrapper dw_gather_gemm over the down
// (8-child) map, the broadcast-k up map and the 27-offset rank tables (the
// k3-table mode, the weight cotangent of pallas_conv_op("k3", ...)).
//
//   dW[k] = sum_{e < count[k]} feats[fidx[k][e]]^T (x) g[gidx[k][e]]
//
// over the lists of the conv's map (hit_lists.cu): a level's k3 map (the
// self-keyed search and the tables give the same lists), a coarse level's
// child map (down) or a fine level's parent / octant map (up, row_ok =
// valid & parent_ok folded in: children of parents that overflowed the
// coarse capacity contribute nothing).  feats is the conv's input level
// (fine for down, coarse for up, the level itself for k3), g its output
// cotangent masked by the output level's validity.
//
// Bound on the card: each hit row costs 2 * Cin * Cout FLOPs against one
// gathered feature row and one g row; the wide convs of the decoder
// (256/384 channels) are bound by operations, the narrow ones (the stem,
// the down convs) by bytes.  Design: dw_gemm.cuh (a tensor-core
// gather-GEMM per (offset, dW tile, slice of the list), slices summed in a
// fixed order).  The TPU kernel's one-hot window gathers, lane packing and
// 128-aligned windows are VMEM workarounds with no counterpart here: a
// list entry is a plain row index.

#include "dw_gemm.cuh"

// feats [rows_in, cin], g [total, cout] (the same dtype, rows flattened),
// lists [2, taps, total] int32 and count [taps] int32 (hit_lists.cu), part
// [slots, cin, cout] f32 (unused when slots == taps), out [taps, cin,
// cout] f32; all contiguous.  Returns cudaGetLastError().
extern "C" int mrcc_dw_f32(const void* feats, const void* g, const int* lists,
                           const int* count, float* part, float* out,
                           int taps, int total, int cin, int cout, int slots,
                           cudaStream_t stream) {
  return mrcc::dw_launch<float>(feats, g, lists, count, part, out, taps,
                                total, cin, cout, slots, stream);
}

extern "C" int mrcc_dw_bf16(const void* feats, const void* g,
                            const int* lists, const int* count, float* part,
                            float* out, int taps, int total, int cin,
                            int cout, int slots, cudaStream_t stream) {
  return mrcc::dw_launch<__nv_bfloat16>(feats, g, lists, count, part, out,
                                        taps, total, cin, cout, slots,
                                        stream);
}
