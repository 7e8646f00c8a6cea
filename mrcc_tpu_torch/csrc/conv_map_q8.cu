// B7 — int8 gather-GEMMs over explicit kernel maps (k=2 s=2 down conv, its
// transpose, and the k=3 s=1 conv over neighbour tables).
//
// Replaces: mrcc_tpu/ops/conv_pallas.py::_gather_gemm_call_q8 in its
// k2-down, broadcast-k up and k3-table (identity_k = 13) modes with the
// quantisation of its wrapper gather_gemm_conv_tiled_q8, and the int8
// variant of _gather_gemm_call_hbm: these kernels read global memory at
// any N.
//
//   down: out[b, p] = sum_g T( f32( sum_{k<8} child_hit[k, b, p]
//                 * q[b, child_idx[k, b, p], group g] . Wq[k, group g] )
//                 * m[g] )
//   k3:   the same over the 27-offset table nbr_idx / nbr_hit [27, B, N]
//   up:   out[b, c] = sum_g T( f32( row_ok[b, c]
//                 * q[b, parent_idx[b, c], group g] . Wq[octant[b, c], group g] )
//                 * m[g, octant[b, c]] )
//
// q the int8 activations, Wq the per-group int8 weights, m the f32 column
// scales (q8_quantize.cuh): one per output column for the down and k3
// convs, one per octant and output column for the up conv, whose octants
// do not share a scale.  The sum over groups g is taken in the output type
// T in group order.  row_ok is valid & parent_ok (children of overflowed
// parents alias slot capacity - 1 and contribute nothing).
//
// Bound on the card: 2 * Cin * Cout int8 operations per hit (1,979 TOP/s)
// against the gathered rows, the weights and the output; bytes at the
// main path's shapes.  A 64-row tile over the child map would multiply
// all 8 offsets of every coarse row, most of them misses, and an up conv
// tile would need all 8 octants' weights per step.  Design (q8_mma.cuh):
//   - down / up: K3's (conv_map.cu) in int8: the int8 list GEMM
//     (mma.sync m16n8k32) over the per-octant hit lists of the map
//     (hit_lists.cu, listed once a map).  Up
//     dequantises each group with its octant's scales and stores the fine
//     rows (zero_rows_q8_kernel clears the rest); down stores each fine
//     row's int32 product per group in a scratch and child_sum_q8_kernel
//     sums each coarse row's children in int32, then dequantises.
//   - k3 table: B6's int8 tile (gather_mma_q8_kernel) with the table row
//     source, so both int8 k3 routes give the same bits at equal groups.
// No host sync, no float atomics: the same bits for the same inputs.

#include "k3_sources.cuh"
#include "q8_mma.cuh"
#include "q8_quantize.cuh"

namespace {

using namespace mrcc;

// B7's name for the k3 tables' row source.
struct Q8Table : tc::NbrTable {};

template <typename T>
int k3map(const void* q, const void* wq, const float* scale,
          const int* nbr_idx, const uint8_t* nbr_hit, int* lists, void* out,
          int batch, int n, int cin, int cpad, int cout, int gw, int ng,
          cudaStream_t stream) {
  const cudaError_t err = q8::launch_gather_mma<T>(
      q, wq, scale, Q8Table{{nbr_idx, nbr_hit, batch}}, lists, out, batch, n,
      q8::Groups{cin, cpad, gw, ng}, cout, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int list_gemm(const void* q, const void* wq, const float* scale,
              const int* src, const int* dst, const int* count, void* out,
              int taps, int total, int out_rows, int cin, int cpad, int cout,
              int gw, int ng, int up, cudaStream_t stream) {
  const q8::Groups gr{cin, cpad, gw, ng};
  return static_cast<int>(
      up ? q8::launch_list_gemm<T, true>(q, wq, scale, src, dst, count, out,
                                         nullptr, taps, total, out_rows, gr,
                                         cout, stream)
         : q8::launch_list_gemm<T, false>(q, wq, scale, src, dst, count,
                                          nullptr, static_cast<int*>(out),
                                          taps, total, out_rows, gr, cout,
                                          stream));
}

}  // namespace

// The quantisation pass of every int8 conv (q8_quantize.cuh): x [rows,
// cin] (the suffix's type), act_absmax [cin] f32 or null (the dynamic
// absmax), w [taps, cin, cout] f32 -> q [rows, cpad], wq [taps, cout, cpad]
// int8, m [ng, cout] f32 ([ng, taps, cout] per_octant); scratch: cin + ng
// * (per_octant ? taps : 1) * cout floats.  Returns cudaGetLastError().
extern "C" int mrcc_quantize_q8_f32(const void* x, const float* act_absmax,
                                    const float* w, float* scratch, void* q,
                                    void* wq, float* m, int rows, int cin,
                                    int cpad, int taps, int cout, int gw,
                                    int ng, int per_octant,
                                    cudaStream_t stream) {
  return static_cast<int>(q8::launch_quantize<float>(
      x, act_absmax, w, scratch, q, wq, m, rows, cin, cpad, taps, cout, gw,
      ng, per_octant, stream));
}

extern "C" int mrcc_quantize_q8_bf16(const void* x, const float* act_absmax,
                                     const float* w, float* scratch, void* q,
                                     void* wq, float* m, int rows, int cin,
                                     int cpad, int taps, int cout, int gw,
                                     int ng, int per_octant,
                                     cudaStream_t stream) {
  return static_cast<int>(q8::launch_quantize<__nv_bfloat16>(
      x, act_absmax, w, scratch, q, wq, m, rows, cin, cpad, taps, cout, gw,
      ng, per_octant, stream));
}

// The int8 list GEMM: for e < count[k], row src[k][e] of q [rows_in, cpad]
// times wq[k] ([taps, cout, cpad]), per group.  up: dequantised with
// scale [ng, taps, cout] and stored to row dst[k][e] of out [out_rows,
// cout] (the suffix's type); else the group's int32 sums to row dst[k][e]
// of out = y [ng, out_rows, cout] int32.  Each dst row lies in at most one
// list.  Returns cudaGetLastError().
extern "C" int mrcc_list_gemm_q8_f32(const void* q, const void* wq,
                                     const float* scale, const int* src,
                                     const int* dst, const int* count,
                                     void* out, int taps, int total,
                                     int out_rows, int cin, int cpad,
                                     int cout, int gw, int ng, int up,
                                     cudaStream_t stream) {
  return list_gemm<float>(q, wq, scale, src, dst, count, out, taps, total,
                          out_rows, cin, cpad, cout, gw, ng, up, stream);
}

extern "C" int mrcc_list_gemm_q8_bf16(const void* q, const void* wq,
                                      const float* scale, const int* src,
                                      const int* dst, const int* count,
                                      void* out, int taps, int total,
                                      int out_rows, int cin, int cpad,
                                      int cout, int gw, int ng, int up,
                                      cudaStream_t stream) {
  return list_gemm<__nv_bfloat16>(q, wq, scale, src, dst, count, out, taps,
                                  total, out_rows, cin, cpad, cout, gw, ng,
                                  up, stream);
}

// The down conv's child sum: y [ng, B * n_in, cout] int32, scale [ng, cout]
// f32, child_idx / child_hit [8, B, n_out], out [B, n_out, cout] in the
// suffix's type.  Returns cudaGetLastError().
extern "C" int mrcc_child_sum_q8_f32(const int* y, const float* scale,
                                     const int* child_idx,
                                     const uint8_t* child_hit, void* out,
                                     int batch, int n_in, int n_out, int cout,
                                     int ng, cudaStream_t stream) {
  return static_cast<int>(q8::launch_child_sum<float>(
      y, scale, child_idx, child_hit, out, batch, n_in, n_out, cout, ng,
      stream));
}

extern "C" int mrcc_child_sum_q8_bf16(const int* y, const float* scale,
                                      const int* child_idx,
                                      const uint8_t* child_hit, void* out,
                                      int batch, int n_in, int n_out,
                                      int cout, int ng, cudaStream_t stream) {
  return static_cast<int>(q8::launch_child_sum<__nv_bfloat16>(
      y, scale, child_idx, child_hit, out, batch, n_in, n_out, cout, ng,
      stream));
}

// The up conv's zero pass: out [rows, cout] rows whose row_ok is false (or
// whose octant is outside 0..7) set to 0.  Returns cudaGetLastError().
extern "C" int mrcc_zero_rows_q8_f32(const uint8_t* row_ok, const int* octant,
                                     void* out, int rows, int cout,
                                     cudaStream_t stream) {
  return static_cast<int>(
      q8::launch_zero_rows<float>(row_ok, octant, out, rows, cout, stream));
}

extern "C" int mrcc_zero_rows_q8_bf16(const uint8_t* row_ok,
                                      const int* octant, void* out, int rows,
                                      int cout, cudaStream_t stream) {
  return static_cast<int>(q8::launch_zero_rows<__nv_bfloat16>(
      row_ok, octant, out, rows, cout, stream));
}

// k3 table: q [B, n, cpad] int8, wq [27, cout, cpad] int8, scale [ng,
// cout] f32, nbr_idx [27, B, n] int32, nbr_hit [27, B, n] bool, out [B, n,
// cout].  lists: int32 scratch of B * ceil(n / 64) * (27 * 64 + 28) where
// cout > 128, else may be null.  Returns cudaGetLastError().
extern "C" int mrcc_conv_k3map_q8_f32(const void* q, const void* wq,
                                      const float* scale, const int* nbr_idx,
                                      const uint8_t* nbr_hit, int* lists,
                                      void* out, int batch, int n, int cin,
                                      int cpad, int cout, int gw, int ng,
                                      cudaStream_t stream) {
  return k3map<float>(q, wq, scale, nbr_idx, nbr_hit, lists, out, batch, n,
                      cin, cpad, cout, gw, ng, stream);
}

extern "C" int mrcc_conv_k3map_q8_bf16(const void* q, const void* wq,
                                       const float* scale,
                                       const int* nbr_idx,
                                       const uint8_t* nbr_hit, int* lists,
                                       void* out, int batch, int n, int cin,
                                       int cpad, int cout, int gw, int ng,
                                       cudaStream_t stream) {
  return k3map<__nv_bfloat16>(q, wq, scale, nbr_idx, nbr_hit, lists, out,
                              batch, n, cin, cpad, cout, gw, ng, stream);
}
