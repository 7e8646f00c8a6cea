// K3's down and up convs as one operation on tensor cores, a list GEMM
// (conv_map.cu):
//
//   out[dst[k][e], :] = feats[src[k][e], :] @ W[k]  (k < taps, e < count[k])
//
// over per-octant hit lists (hit_lists.cu).  The up conv lists each fine
// row with row_ok under its octant k, src its parent's coarse row and dst
// the fine row itself.  The down conv lists each fine row that has a
// parent, src = dst = the fine row, into an f32 scratch Y; child_sum_kernel
// then sums each coarse row's children.  Every dst row lies in at most one
// list, so every stored row is written once: no float atomics, and the
// same bits for the same inputs.
//
// list_mma_kernel: one block per (octant k, slice of BM = 64 entries of
// list k, column tile of BN = 128).  Slices are numbered octant by octant.
// The grid is sized on the host from the shapes alone: the lists hold at
// most out_rows entries, so at most ceil(out_rows / BM) + taps slices.
// Each block finds its (k, slice) from count[] on the device, and a block
// past the counts exits: no host sync.  Blocks are numbered column tile
// fastest, so the blocks that gather one slice's rows run together and
// share them in L2.  The tile is gather_mma.cuh's: A = feats[src rows of
// the slice], gathered; B = W[k][c0:c0+32, n0:n0+128], one weight slice
// for the whole tile; both by 16-byte cp.async into a ring over the
// 32-channel chunks of Cin (scalar loads where a width is not whole 16-byte
// chunks).  bf16: mma.sync m16n8k16; f32: a TF32 split x = hi + lo (both
// rounded to nearest) and all four products of each k8 step summed from
// zero, then added in f32 (4xTF32; see mma_stage).  Warps whose
// 16-row groups lie past the slice, or whose columns lie past Cout, skip
// their MMAs.  The epilogue stores tile row r to dst[slice entry r].
#pragma once

#include <limits.h>

#include "gather_mma.cuh"

namespace mrcc {
namespace lm {

using tc::BK;
using tc::BM;
using tc::BN;
using tc::THREADS;

template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * tc::Geometry<T>::STAGES * tc::stage_elems<T>();
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both rounded to TF32 (hi as gather_mma.cuh's split_tf32,
// lo to nearest rather than truncated by the MMA).
__device__ __forceinline__ void split_fine(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_stage(float (&acc)[2][4][4],
                                          const __nv_bfloat16* As,
                                          const __nv_bfloat16* Bs, int wm,
                                          int wn, const bool (&on)[2]) {
  tc::mma_stage(acc, As, Bs, wm, wn, on);
}

// f32: all four TF32 products of the split (al bl, al bh, ah bl, ah bh:
// the small ones first) of each k8 step, summed from zero by the tensor
// cores and then added to acc in f32 (the tensor cores' accumulation
// truncates).  K2's tile keeps three (it drops al bl and lets the MMA
// truncate lo).
__device__ __forceinline__ void mma_stage(float (&acc)[2][4][4],
                                          const float* As, const float* Bs,
                                          int wm, int wn,
                                          const bool (&on)[2]) {
  constexpr int ALD = tc::Geometry<float>::A_LD;
  constexpr int BLD = tc::Geometry<float>::B_LD;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (!on[mi]) continue;
      const float* p = As + (wm * 32 + mi * 16 + g) * ALD + kk + t;
      split_fine(p[0], ah[mi][0], al[mi][0]);
      split_fine(p[8 * ALD], ah[mi][1], al[mi][1]);
      split_fine(p[4], ah[mi][2], al[mi][2]);
      split_fine(p[8 * ALD + 4], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float* p = Bs + (kk + t) * BLD + wn * 32 + ni * 8 + g;
      split_fine(p[0], bh[ni][0], bl[ni][0]);
      split_fine(p[4 * BLD], bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (!on[mi]) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        tc::mma_tf32(d, al[mi], bl[ni][0], bl[ni][1]);
        tc::mma_tf32(d, al[mi], bh[ni][0], bh[ni][1]);
        tc::mma_tf32(d, ah[mi], bl[ni][0], bl[ni][1]);
        tc::mma_tf32(d, ah[mi], bh[ni][0], bh[ni][1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] += d[q];
      }
    }
  }
}

// The prologue of a list GEMM block: find slice `slice` of the lists
// (slices of BM entries, numbered octant by octant, from count[] on the
// device: head = octant, first entry, entries) and load its src and dst
// rows into rows (-1 past the slice).  False (uniform over the block) for
// a slice past the lists.
__device__ __forceinline__ bool load_slice(const int* __restrict__ src,
                                           const int* __restrict__ dst,
                                           const int* __restrict__ count,
                                           int taps, int total, int slice,
                                           int (&rows)[2][BM],
                                           int (&head)[3]) {
  if (threadIdx.x == 0) {
    int k = 0;
    int start = 0;
    int cnt = 0;
    for (; k < taps; ++k) {
      cnt = __ldg(count + k);
      const int s = (cnt + BM - 1) / BM;
      if (slice < start + s) break;
      start += s;
    }
    head[0] = k;
    head[1] = (slice - start) * BM;
    head[2] = min(BM, cnt - (slice - start) * BM);
  }
  __syncthreads();
  const int k = head[0];
  if (k >= taps) return false;
  if (threadIdx.x < 2 * BM) {
    const int side = threadIdx.x / BM;
    const int r = threadIdx.x % BM;
    const int* list = (side ? dst : src) + static_cast<size_t>(k) * total;
    rows[side][r] = r < head[2] ? __ldg(list + head[1] + r) : -1;
  }
  __syncthreads();
  return true;
}

// grid (slices * ceil(cout / BN)), THREADS threads, smem_bytes<T>() dynamic
// shared memory.  feats [rows_in, cin], w [taps, cin, cout]; src / dst
// [taps, total] int32 (entry e of list k at k * total + e), count [taps];
// out [out_rows, cout].
template <typename T, typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
list_mma_kernel(const T* __restrict__ feats, const T* __restrict__ w,
                const int* __restrict__ src, const int* __restrict__ dst,
                const int* __restrict__ count, OutT* __restrict__ out,
                int taps, int total, int cin, int cout, int vec_a,
                int vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int rows[2][BM];  // the slice's src and dst rows, -1 past it
  __shared__ int head[3];      // octant, first entry, entries
  constexpr int STAGES = tc::Geometry<T>::STAGES;
  constexpr int SE = tc::stage_elems<T>();
  constexpr int A_LD = tc::Geometry<T>::A_LD;
  T* ring = reinterpret_cast<T*>(smem);

  const int tiles_n = (cout + BN - 1) / BN;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  // a slice past the lists (uniform over the block)
  if (!load_slice(src, dst, count, taps, total, blockIdx.x / tiles_n, rows,
                  head))
    return;
  const int k = head[0];
  const int m = head[2];

  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const bool on[2] = {wm * 32 < m, wm * 32 + 16 < m};
  const bool cols = n0 + wn * 32 < cout;
  const T* wk = w + static_cast<size_t>(k) * cin * cout;
  const int steps = (cin + BK - 1) / BK;
  auto load_stage = [&](int s) {
    T* As = ring + (s % STAGES) * SE;
    tc::load_a(As, feats, rows[0], cin, s * BK, vec_a);
    tc::load_b(As + BM * A_LD, wk, cin, cout, s * BK, n0, vec_b);
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s);
    tc::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; stage s - 1 is free
    if (s + STAGES - 1 < steps) load_stage(s + STAGES - 1);
    tc::cp_async_commit();
    const T* As = ring + (s % STAGES) * SE;
    if (cols) mma_stage(acc, As, As + BM * A_LD, wm, wn, on);
  }
  tc::cp_async_wait<0>();
  if (!cols) return;
  tc::store_rows(
      out, acc, [&](int lr) { return lr < m ? rows[1][lr] : -1; }, n0, cout,
      wm, wn);
}

template <int V>
__device__ __forceinline__ void load_vec(float (&v)[V],
                                         const float* __restrict__ p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) v[q] = p[q];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) p[q] = v[q];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[V]) {
  if constexpr (V == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) p[q] = __float2bfloat16(v[q]);
  }
}

// The down conv's second pass, bound by bytes:
//   out[b, p, :] = sum_{k < 8} child_hit[k, b, p]
//                              * y[b * n_in + child_idx[k, b, p], :]
// in f32, octant by octant, cast once to T (0 where no child hits).  One
// warp a coarse row: lanes 0-7 read its eight map entries, then the warp
// sums V-column chunks of the children's rows (16-byte loads for V = 4).
template <typename T, int V>
__global__ void __launch_bounds__(256)
child_sum_kernel(const float* __restrict__ y,
                 const int* __restrict__ child_idx,
                 const uint8_t* __restrict__ child_hit, T* __restrict__ out,
                 int batch, int n_in, int n_out, int cout) {
  const int lane = threadIdx.x & 31;
  const long long rows = static_cast<long long>(batch) * n_out;
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long row =
           static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
           (threadIdx.x >> 5);
       row < rows; row += warps) {
    int j = -1;
    if (lane < 8) {  // [8, B, n_out]: entry (k, b, p) at k * rows + row
      const size_t o = static_cast<size_t>(lane) * rows + row;
      if (child_hit[o]) j = child_idx[o];
    }
    const long long base = row / n_out * n_in;  // b * n_in
    const float* child[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int jk = __shfl_sync(0xffffffffu, j, k);
      child[k] = jk < 0 ? nullptr : y + (base + jk) * cout;
    }
    T* o = out + row * cout;
    for (int c = lane * V; c < cout; c += 32 * V) {
      float acc[V];
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (child[k] == nullptr) continue;
        float v[V];
        load_vec<V>(v, child[k] + c);
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] += v[q];
      }
      store_vec<V>(o + c, acc);
    }
  }
}

// The up conv's rows that no list names (not row_ok, or an octant outside
// 0..7: padding rows and the children of overflowed parents) are cleared:
// one warp a row of out [rows, cout].
template <typename T>
__global__ void __launch_bounds__(256)
zero_rows_kernel(const uint8_t* __restrict__ row_ok,
                 const int* __restrict__ octant, T* __restrict__ out,
                 long long rows, int cout) {
  const int lane = threadIdx.x & 31;
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long row =
           static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
           (threadIdx.x >> 5);
       row < rows; row += warps) {
    if (row_ok[row] && static_cast<unsigned>(octant[row]) < 8u) continue;
    T* o = out + row * cout;
    for (int c = lane; c < cout; c += 32) o[c] = tc::zero_of<T>();
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Blocks of 8 warps for a warp-a-row pass over `rows` rows.
inline int row_blocks(long long rows) {
  const long long want = (rows + 7) / 8;
  return static_cast<int>(want < 4096 ? want : 4096);
}

// The list GEMM into out [out_rows, cout] (OutT: f32, or the feature type).
// Returns the first CUDA error.
template <typename T, typename OutT>
cudaError_t launch_list_gemm(const void* feats, const void* w, const int* src,
                             const int* dst, const int* count, void* out,
                             int taps, int total, int out_rows, int cin,
                             int cout, cudaStream_t stream) {
  if (taps <= 0 || total <= 0 || out_rows <= 0 || cout <= 0)
    return cudaSuccess;
  constexpr int V = tc::Geometry<T>::VEC;
  const int vec_a = cin % V == 0 && aligned16(feats);
  const int vec_b = cout % V == 0 && aligned16(w);
  constexpr size_t smem = smem_bytes<T>();
  const cudaError_t err = cudaFuncSetAttribute(
      list_mma_kernel<T, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // each stored row lies in at most one list: at most out_rows entries
  const long long per_list = (static_cast<long long>(total) + BM - 1) / BM;
  long long slices = (static_cast<long long>(out_rows) + BM - 1) / BM + taps;
  if (slices > taps * per_list) slices = taps * per_list;
  const long long blocks = slices * ((cout + BN - 1) / BN);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  list_mma_kernel<T, OutT><<<static_cast<unsigned>(blocks), THREADS, smem,
                             stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(w), src, dst, count,
      static_cast<OutT*>(out), taps, total, cin, cout, vec_a, vec_b);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_child_sum(const float* y, const int* child_idx,
                             const uint8_t* child_hit, void* out, int batch,
                             int n_in, int n_out, int cout,
                             cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * n_out;
  if (rows <= 0 || cout <= 0) return cudaSuccess;
  const bool vec = cout % 4 == 0 && aligned16(y) && aligned16(out);
  const auto kernel = vec ? child_sum_kernel<T, 4> : child_sum_kernel<T, 1>;
  kernel<<<row_blocks(rows), 256, 0, stream>>>(
      y, child_idx, child_hit, static_cast<T*>(out), batch, n_in, n_out,
      cout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_zero_rows(const uint8_t* row_ok, const int* octant,
                             void* out, long long rows, int cout,
                             cudaStream_t stream) {
  if (rows <= 0 || cout <= 0) return cudaSuccess;
  zero_rows_kernel<T><<<row_blocks(rows), 256, 0, stream>>>(
      row_ok, octant, static_cast<T*>(out), rows, cout);
  return cudaGetLastError();
}

}  // namespace lm
}  // namespace mrcc
