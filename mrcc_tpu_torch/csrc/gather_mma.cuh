// Tensor-core tile of the gather-GEMM k3 convolutions (conv_sk.cu, and the
// k3-table conv of conv_map.cu):
//
//   out[b, i, :] = sum_k sum_c A_k[i, c] * W[k, c, :],
//   A_k[i, :] = feats[b, nbr_k(i), :] (zero where nbr_k(i) < 0).
//
// The row source (a template parameter: the key search of the self-keyed
// conv, the neighbour tables of the k3-table conv) resolves each tile of
// BM = 64 output rows once: its 27 x 64 neighbours, the list of offsets
// some row of the tile hits and, per offset, which 16-row groups hit (a
// warp skips the MMAs of a group without one).  Where Cout fits one column
// tile of BN = 128, the MMA block resolves its own row tile; else a resolve
// kernel writes each row tile's lists once and one MMA block runs per
// (row tile, column tile), so that a level whose valid rows fill few tiles
// still spreads over the card.  Each column tile runs a ring of
// STAGES shared-memory stages over the flattened (offset with a hit,
// 32-channel chunk) steps: gathered rows and the weight slice
// W[k][c0:c0+32, n0:n0+128] arrive by 16-byte cp.async (zero-filled for a
// miss or a channel past Cin), so the copies of later steps overlap the
// MMAs of the current one.  Eight warps, 2 x 4, each own 32 x 32 outputs
// in f32 registers:
//   - bf16: mma.sync m16n8k16 with f32 accumulation; A fragments by
//     ldmatrix, B fragments by ldmatrix.trans from the [k][n] weight tile;
//   - f32: mma.sync m16n8k8 in TF32 as a 3xTF32 split (x = hi + lo, both
//     TF32; a_lo b_hi + a_hi b_lo + a_hi b_hi), which keeps about 21 bits
//     of each product where plain TF32 keeps 11, each k8 step's three
//     products summed from zero and added in f32 (the tensor cores'
//     accumulation truncates); the split is two integer operations and a
//     subtraction per value.
// Rows of Cin (or Cout) that are not whole 16-byte chunks (Cin = 130,
// Cout = 70) take scalar loads into the same ring.  A stem conv (Cin <= 8)
// packs the (offset, channel) pairs along K, so its 27 offsets take
// ceil(27 Cin / 32) stages, not 27.  Shared-memory rows are
// padded (A: +16 bytes, B: +16 / +32 bytes) so that ldmatrix phases and the
// f32 fragment loads hit 32 distinct banks.
//
// Ordered mode (gather_mma_ordered_kernel): 64 consecutive rows in key
// order together hit nearly all 27 offsets although each row hits a few,
// so a tile runs 2-4x the stages its rows' hits need.  A level's k3 order
// (k3_order.cu, built once per level) cuts the offsets into S segments of
// 27 / S and sorts each segment's rows by their hit mask in it (stable:
// rows of one mask stay in key order); a tile is 64 rows of one segment's
// order and runs only that segment's offsets, from lists resolved once per
// level.  Each row's f32 sum is carried from segment to segment in memory
// (out itself in f32, an f32 scratch in bf16): every row sees the same f32
// additions in the same order as in the one-pass tile, less additions of
// exact zeros, so both give the same bits.  One launch of as many blocks
// as the card holds: each loops over the tiles with rows, taking the next
// by a ticket in segment order, and a tile whose rows carry a partial sum
// waits until every tile of the earlier segments of its item is done.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mrcc {
namespace tc {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int K3 = 27;

template <typename T>
struct Geometry;
template <>
struct Geometry<__nv_bfloat16> {
  static constexpr int A_LD = BK + 8;  // 80-byte rows
  static constexpr int B_LD = BN + 8;  // 272-byte rows
  static constexpr int STAGES = 4;
  static constexpr int VEC = 8;        // elements of a 16-byte chunk
};
template <>
struct Geometry<float> {
  static constexpr int A_LD = BK + 4;  // 144-byte rows
  static constexpr int B_LD = BN + 8;  // 544-byte rows
  static constexpr int STAGES = 3;
  static constexpr int VEC = 4;
};

template <typename T>
__host__ __device__ constexpr int stage_elems() {
  return BM * Geometry<T>::A_LD + BK * Geometry<T>::B_LD;
}

// Dynamic shared memory of one block: the ring, the neighbour list
// [27][BM], the compacted offsets [28] and the per-offset masks of 16-row
// groups with a hit [27].
template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * Geometry<T>::STAGES * stage_elems<T>() +
         sizeof(int) * (K3 * BM + K3 + K3 + 1);
}

// One tile's list of a level's k3 order (k3_order.cu), for segments of ks
// offsets: nbr[j * BM + r] (the input row of the segment's offset j for
// tile row r, -1 for a miss), rows[BM] (the output row of tile row r with
// its flags, -1 for none), klist[ks] (the segment's offsets some row hits,
// each with its mask of 16-row groups that hit: j | mask << 8; 0 past the
// count), the count, and the number of rows.
__host__ __device__ constexpr int order_list_ints(int ks) {
  return ks * BM + BM + ks + 2;
}
constexpr int ROW_LOAD = 1 << 30;   // an earlier segment holds its partial sum
constexpr int ROW_FINAL = 1 << 29;  // no later segment hits the row
constexpr int ROW_INDEX = ROW_FINAL - 1;

// Dynamic shared memory of an ordered block, but for its groups' first
// items: the ring, the neighbour list [27][BM] (ks rows used) and the rest
// of its tile's list.
template <typename T>
__host__ __device__ constexpr size_t ordered_smem_bytes() {
  return sizeof(T) * Geometry<T>::STAGES * stage_elems<T>() +
         sizeof(int) * (K3 * BM + BM + K3 + 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// A stage: As[r][kk] = feats[src[r], c0 + kk] (0 for src[r] < 0 or a
// channel past cin).  vec: cin is a whole number of 16-byte chunks.
template <typename T>
__device__ __forceinline__ void load_a(T* As, const T* __restrict__ fb,
                                       const int* src, int cin, int c0,
                                       bool vec) {
  constexpr int LD = Geometry<T>::A_LD;
  constexpr int V = Geometry<T>::VEC;
  if (vec) {
    constexpr int CH = BK / V;
    for (int e = threadIdx.x; e < BM * CH; e += THREADS) {
      const int r = e / CH;
      const int c = c0 + (e % CH) * V;
      const int s = src[r];
      const bool ok = s >= 0 && c < cin;
      cp_async16(As + r * LD + (e % CH) * V,
                 ok ? fb + static_cast<size_t>(s) * cin + c : fb,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int c = c0 + e % BK;
      const int s = src[r];
      As[r * LD + e % BK] = (s >= 0 && c < cin)
                                ? fb[static_cast<size_t>(s) * cin + c]
                                : zero_of<T>();
    }
  }
}

// A stage of the packed mode (Cin <= 8): the K dimension runs over the
// flattened (offset, channel) pairs e = k * cin + c, so all 27 offsets of
// a stem conv fit a few stages.  As[r][kk] = feats[nbr[k][r], c] for
// e = e0 + kk < kdim (0 for a miss or past kdim); scalar loads.
template <typename T>
__device__ __forceinline__ void load_a_packed(T* As,
                                              const T* __restrict__ fb,
                                              const int* nbr, int cin,
                                              int kdim, int e0) {
  constexpr int LD = Geometry<T>::A_LD;
  for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
    const int r = i / BK;
    const int e = e0 + i % BK;
    T v = zero_of<T>();
    if (e < kdim) {
      const int s = nbr[(e / cin) * BM + r];
      if (s >= 0) v = fb[static_cast<size_t>(s) * cin + e % cin];
    }
    As[r * LD + i % BK] = v;
  }
}

// B stage: Bs[kk][j] = w[c0 + kk, n0 + j] of one [cin, cout] slice (0 past
// cin or cout).  vec: cout is a whole number of 16-byte chunks.
template <typename T>
__device__ __forceinline__ void load_b(T* Bs, const T* __restrict__ wk,
                                       int cin, int cout, int c0, int n0,
                                       bool vec) {
  constexpr int LD = Geometry<T>::B_LD;
  constexpr int V = Geometry<T>::VEC;
  if (vec) {
    constexpr int CH = BN / V;
    for (int e = threadIdx.x; e < BK * CH; e += THREADS) {
      const int kk = e / CH;
      const int c = c0 + kk;
      const int col = n0 + (e % CH) * V;
      const bool ok = c < cin && col < cout;
      cp_async16(Bs + kk * LD + (e % CH) * V,
                 ok ? wk + static_cast<size_t>(c) * cout + col : wk,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int kk = e / BN;
      const int c = c0 + kk;
      const int col = n0 + e % BN;
      Bs[kk * LD + e % BN] = (c < cin && col < cout)
                                 ? wk[static_cast<size_t>(c) * cout + col]
                                 : zero_of<T>();
    }
  }
}

// ---------------------------------------------------------- bf16 MMA

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage of the warp's 32 x 32 tile: two k16 steps.  The MMAs
// accumulate in acc: the drift of the tensor cores' truncating f32 sums
// (see the f32 stage) stays far under a bf16 output's rounding.  on[mi]:
// some row of the 16-row group mi hits this offset (else its MMAs add
// zeros and are skipped; uniform over the warp).
__device__ __forceinline__ void mma_stage(float (&acc)[2][4][4],
                                          const __nv_bfloat16* As,
                                          const __nv_bfloat16* Bs, int wm,
                                          int wn, const bool (&on)[2]) {
  constexpr int ALD = Geometry<__nv_bfloat16>::A_LD;
  constexpr int BLD = Geometry<__nv_bfloat16>::B_LD;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[2][4];
    uint32_t bq[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (on[mi])
        ldmatrix_x4(a[mi], As + (wm * 32 + mi * 16 + (lane & 15)) * ALD +
                               kk + (lane >> 4) * 8);
    }
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      ldmatrix_x4_trans(bq[nj], Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                         BLD +
                                     wn * 32 + nj * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (!on[mi]) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_bf16(acc[mi][ni], a[mi], bq[ni >> 1][(ni & 1) * 2],
                 bq[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
}

// ------------------------------------------------------ f32: 3xTF32 MMA

// x = hi + lo: hi is x rounded to TF32 (half away from zero on the
// magnitude, as cvt.rna does, in two integer operations) and lo = x - hi,
// exact in f32; the MMA reads lo's top 19 bits (it truncates to TF32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage of the warp's 32 x 32 tile: four k8 steps, three MMAs each.
// Each k8 step's three products are summed by the tensor cores from zero
// and then added to acc in f32: the tensor cores' f32 accumulation
// truncates, so one accumulator carried through ~1000 MMAs drifts towards
// zero (3e-5 relative at 384 -> 384, over 1e-5), while three MMAs a
// partial and round-to-nearest adds between partials hold 5e-7.
__device__ __forceinline__ void mma_stage(float (&acc)[2][4][4],
                                          const float* As, const float* Bs,
                                          int wm, int wn,
                                          const bool (&on)[2]) {
  constexpr int ALD = Geometry<float>::A_LD;
  constexpr int BLD = Geometry<float>::B_LD;
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
      split_tf32(p[0], ah[mi][0], al[mi][0]);
      split_tf32(p[8 * ALD], ah[mi][1], al[mi][1]);
      split_tf32(p[4], ah[mi][2], al[mi][2]);
      split_tf32(p[8 * ALD + 4], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float* p = Bs + (kk + t) * BLD + wn * 32 + ni * 8 + g;
      split_tf32(p[0], bh[ni][0], bl[ni][0]);
      split_tf32(p[4 * BLD], bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (!on[mi]) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(d, al[mi], bh[ni][0], bh[ni][1]);
        mma_tf32(d, ah[mi], bl[ni][0], bl[ni][1]);
        mma_tf32(d, ah[mi], bh[ni][0], bh[ni][1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] += d[q];
      }
    }
  }
}

// ------------------------------------------------------------ epilogue

__device__ __forceinline__ void store2(float* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b,
                                       bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
  }
}

// Tile rows lr = wm * 32 + mi * 16 + g (+ 8), columns n0 + wn * 32 + ni *
// 8 + 2t (+ 1): the m16n8 accumulator layout.  row_of(lr) is the output row
// of tile row lr, or -1 (not stored).
template <typename T, class RowOf>
__device__ __forceinline__ void store_rows(T* __restrict__ ob,
                                           const float (&acc)[2][4][4],
                                           const RowOf& row_of, int n0,
                                           int cout, int wm, int wn) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool even = (cout & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_of(wm * 32 + mi * 16 + g + h * 8);
      if (r < 0) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = n0 + wn * 32 + ni * 8 + 2 * t;
        if (c >= cout) continue;
        T* p = ob + static_cast<size_t>(r) * cout + c;
        const float v0 = acc[mi][ni][2 * h];
        const float v1 = acc[mi][ni][2 * h + 1];
        if (even || c + 1 >= cout) {
          store2(p, v0, v1, c + 1 < cout);
        } else {  // odd cout: the pair is not aligned
          store2(p, v0, 0.f, false);
          store2(p + 1, v1, 0.f, false);
        }
      }
    }
}

// Columns c and c + 1 (those below cout) of one row at p, as store_rows
// stores them.
template <typename T>
__device__ __forceinline__ void store_cols(T* p, float v0, float v1, int c,
                                           int cout) {
  if ((cout & 1) == 0 || c + 1 >= cout) {
    store2(p, v0, v1, c + 1 < cout);
  } else {  // odd cout: the pair is not aligned
    store2(p, v0, 0.f, false);
    store2(p + 1, v1, 0.f, false);
  }
}

// Rows m0 + lr of the block's tile, those below n.
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ ob,
                                           const float (&acc)[2][4][4], int m0,
                                           int n0, int n, int cout, int wm,
                                           int wn) {
  store_rows(
      ob, acc, [&](int lr) { return m0 + lr < n ? m0 + lr : -1; }, n0, cout,
      wm, wn);
}

// ---------------------------------------------------------------- kernel

// One row tile's resolved lists, as they sit in shared memory and in the
// lists scratch: nbr[k * BM + r] (the input row of offset k for output row
// m0 + r, -1 for a miss), then klist[0 .. klist[K3]): the offsets some row
// hits, each with its mask of 16-row groups that hit (k | mask << 8).
constexpr int LIST = K3 * BM + K3 + 1;

// Resolve row tile m0 of item b into nbr / klist (shared memory; any is a
// [K3] scratch).  Source::resolve(b, m0, n, nbr) fills nbr and ends with a
// barrier.
template <class Source>
__device__ __forceinline__ void resolve_tile(const Source& source, int b,
                                             int m0, int n, int* nbr,
                                             int* klist, int* any) {
  if (threadIdx.x < K3) any[threadIdx.x] = 0;
  source.resolve(b, m0, n, nbr);
  for (int e = threadIdx.x; e < K3 * BM; e += THREADS)
    if (nbr[e] >= 0) atomicOr(any + e / BM, 1 << ((e % BM) / 16));
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0;
    for (int k = 0; k < K3; ++k)
      if (any[k]) klist[c++] = k | (any[k] << 8);
    klist[K3] = c;
  }
  __syncthreads();
}

// Where Cout spans several column tiles, each row tile is resolved once
// here into lists [B, tiles, LIST], and the MMA kernel runs one block per
// (row tile, column tile).  grid (tiles, 1, B), THREADS threads.
template <class Source>
__global__ void __launch_bounds__(THREADS)
resolve_kernel(Source source, int* __restrict__ lists, int n) {
  __shared__ int tile[LIST];
  __shared__ int any[K3];
  const int b = blockIdx.z;
  resolve_tile(source, b, blockIdx.x * BM, n, tile, tile + K3 * BM, any);
  int* g = lists + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * LIST;
  for (int e = threadIdx.x; e < LIST; e += THREADS) g[e] = tile[e];
}

// out[b] = sum over the source's (offset, row) hits of feats rows x W[k].
// n output rows of an item, n_in input rows (n for the k3 convs), taps
// offsets of W (27; a strided map may have fewer, which no source row
// names).  SPLIT: block (x, y, b) reads row tile x's lists and computes
// column tile y; else it resolves its row tile itself and loops over every
// column tile.  grid (ceil(n / BM), SPLIT ? ceil(cout / BN) : 1, B),
// THREADS threads, smem_bytes<T>() dynamic shared memory.
template <typename T, class Source, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 2)
gather_mma_kernel(const T* __restrict__ feats, const T* __restrict__ w,
                  Source source, const int* __restrict__ lists,
                  T* __restrict__ out, int n, int n_in, int taps, int cin,
                  int cout, int vec_a, int vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int STAGES = Geometry<T>::STAGES;
  constexpr int SE = stage_elems<T>();
  T* ring = reinterpret_cast<T*>(smem);
  int* nbr = reinterpret_cast<int*>(ring + STAGES * SE);
  int* klist = nbr + K3 * BM;
  int* any = klist + K3 + 1;

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  if (SPLIT) {
    const int* g =
        lists + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * LIST;
    for (int e = threadIdx.x; e < LIST; e += THREADS) nbr[e] = g[e];
    __syncthreads();
  } else {
    resolve_tile(source, b, m0, n, nbr, klist, any);
  }

  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  // packed: K runs over the flattened (offset, channel) pairs, W read as
  // one [27 * cin, cout] matrix; else over (offset with a hit, chunk)
  const bool packed = cin * 4 <= BK;
  const int kdim = taps * cin;
  const int nchunk = (cin + BK - 1) / BK;
  const int steps = klist[K3] == 0 ? 0
                    : packed       ? (kdim + BK - 1) / BK
                                   : klist[K3] * nchunk;
  const T* fb = feats + static_cast<size_t>(b) * n_in * cin;
  T* ob = out + static_cast<size_t>(b) * n * cout;

  auto load_stage = [&](int s, int n0) {
    T* As = ring + (s % STAGES) * SE;
    T* Bs = As + BM * Geometry<T>::A_LD;
    if (packed) {
      load_a_packed(As, fb, nbr, cin, kdim, s * BK);
      load_b(Bs, w, kdim, cout, s * BK, n0, vec_b);
      return;
    }
    const int k = klist[s / nchunk] & 0xff;
    const int c0 = (s % nchunk) * BK;
    load_a(As, fb, nbr + k * BM, cin, c0, vec_a);
    load_b(Bs, w + static_cast<size_t>(k) * cin * cout, cin, cout, c0, n0,
           vec_b);
  };

  const int n_begin = SPLIT ? blockIdx.y * BN : 0;
  const int n_end = SPLIT ? min(cout, n_begin + BN) : cout;
  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < steps) load_stage(s, n0);
      cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage s landed; stage s - 1 is free
      if (s + STAGES - 1 < steps) load_stage(s + STAGES - 1, n0);
      cp_async_commit();
      const T* As = ring + (s % STAGES) * SE;
      const int mask = packed ? 3 : klist[s / nchunk] >> (8 + 2 * wm);
      const bool on[2] = {(mask & 1) != 0, (mask & 2) != 0};
      mma_stage(acc, As, As + BM * Geometry<T>::A_LD, wm, wn, on);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next column tile
    store_tile(ob, acc, m0, n0, n, cout, wm, wn);
  }
}

// The tile over a level's k3 order (k3_order.cu): lists [S, B, tiles,
// order_list_ints(27 / S)] and counts [S, B], the tiles of each group g =
// segment * B + b that hold rows (they come first).  Its work items are
// the (group, row tile with rows, column tile) triples, group by group,
// ctiles column tiles of a row tile together; blocks loop, taking the
// next item by a ticket, so that a block only ever waits on items of
// lower tickets, which running blocks hold or have finished.  An item
// with a ROW_LOAD row first waits until every item of its item's earlier
// segments is done (sync[1 + g'] reaches counts[g'] * ctiles), loads those
// rows' f32 sums from part and runs its segment's offsets (W[segment * ks
// + j]); then it stores each row's sum to out if ROW_FINAL, else to part.
// part is out itself in f32, an f32 [B, n, cout] scratch in bf16.  sync:
// 1 + S * B ints, zero before the launch: the ticket, then each group's
// count of finished items.  Tag only names the launching library's
// kernel.  Any grid (the launcher fills the card once), THREADS threads,
// ordered_smem_bytes<T>(S * B) dynamic shared memory.
template <typename T, class Tag>
__global__ void __launch_bounds__(THREADS, 2)
gather_mma_ordered_kernel(const T* __restrict__ feats,
                          const T* __restrict__ w,
                          const int* __restrict__ lists,
                          const int* __restrict__ counts, float* part,
                          T* out, int* sync, int groups, int batch, int n,
                          int tiles, int ctiles, int ks, int cin, int cout,
                          int vec_a, int vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int STAGES = Geometry<T>::STAGES;
  constexpr int SE = stage_elems<T>();
  T* ring = reinterpret_cast<T*>(smem);
  int* nbr = reinterpret_cast<int*>(ring + STAGES * SE);
  int* rows = nbr + K3 * BM;
  int* klist = rows + BM;
  int* first = klist + K3 + 2;  // [groups + 1]: each group's first item
  __shared__ int ticket;
  __shared__ int group;

  if (threadIdx.x == 0) {
    int c = 0;
    for (int g = 0; g < groups; ++g) {
      first[g] = c;
      c += counts[g] * ctiles;
    }
    first[groups] = c;
  }
  const int lane = threadIdx.x & 31;
  const int wm = (threadIdx.x >> 5) >> 2;
  const int wn = (threadIdx.x >> 5) & 3;
  const int nchunk = (cin + BK - 1) / BK;
  const int len = order_list_ints(ks);

  for (;;) {
    if (threadIdx.x == 0) {
      const int i = atomicAdd(sync, 1);
      int g = 0;
      while (g < groups && first[g + 1] <= i) ++g;
      ticket = i;
      group = g;
    }
    __syncthreads();
    if (ticket >= first[groups]) break;
    const int g = group;
    const int item = ticket - first[g];
    const int n0 = (item % ctiles) * BN;
    const int seg = g / batch;
    const int b = g % batch;
    const int* src =
        lists + (static_cast<size_t>(g) * tiles + item / ctiles) * len;
    for (int e = threadIdx.x; e < len; e += THREADS)
      (e < ks * BM ? nbr + e : rows + (e - ks * BM))[0] = src[e];
    const bool load = __syncthreads_or(
        threadIdx.x < BM && src[ks * BM + threadIdx.x] >= 0 &&
        (src[ks * BM + threadIdx.x] & ROW_LOAD));
    if (load && threadIdx.x == 0) {
      for (int p = 0; p < seg; ++p) {
        const int q = p * batch + b;
        const volatile int* c = sync + 1 + q;
        while (*c < counts[q] * ctiles) __nanosleep(256);
      }
      __threadfence();
    }
    __syncthreads();

    const int steps = klist[ks] * nchunk;
    const T* fb = feats + static_cast<size_t>(b) * n * cin;
    const T* ws = w + static_cast<size_t>(seg) * ks * cin * cout;

    auto load_stage = [&](int s) {
      T* As = ring + (s % STAGES) * SE;
      T* Bs = As + BM * Geometry<T>::A_LD;
      const int k = klist[s / nchunk] & 0xff;
      const int c0 = (s % nchunk) * BK;
      load_a(As, fb, nbr + k * BM, cin, c0, vec_a);
      load_b(Bs, ws + static_cast<size_t>(k) * cin * cout, cin, cout, c0, n0,
             vec_b);
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < steps) load_stage(s);
      cp_async_commit();
    }
    // the rows' sums so far, while the first stages land
    const float* pb = part + static_cast<size_t>(b) * n * cout;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = rows[wm * 32 + mi * 16 + (lane >> 2) + h * 8];
        const bool from = e >= 0 && (e & ROW_LOAD);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int c = n0 + wn * 32 + ni * 8 + 2 * (lane & 3);
          const float* p = pb + static_cast<size_t>(e & ROW_INDEX) * cout + c;
          acc[mi][ni][2 * h] = from && c < cout ? __ldcg(p) : 0.f;
          acc[mi][ni][2 * h + 1] = from && c + 1 < cout ? __ldcg(p + 1) : 0.f;
        }
      }
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage s landed; stage s - 1 is free
      if (s + STAGES - 1 < steps) load_stage(s + STAGES - 1);
      cp_async_commit();
      const T* As = ring + (s % STAGES) * SE;
      const int mask = klist[s / nchunk] >> (8 + 2 * wm);
      const bool on[2] = {(mask & 1) != 0, (mask & 2) != 0};
      mma_stage(acc, As, As + BM * Geometry<T>::A_LD, wm, wn, on);
    }
    cp_async_wait<0>();

    T* ob = out + static_cast<size_t>(b) * n * cout;
    float* qb = part + static_cast<size_t>(b) * n * cout;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = rows[wm * 32 + mi * 16 + (lane >> 2) + h * 8];
        if (e < 0) continue;
        const size_t r = static_cast<size_t>(e & ROW_INDEX) * cout;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int c = n0 + wn * 32 + ni * 8 + 2 * (lane & 3);
          if (c >= cout) continue;
          const float v0 = acc[mi][ni][2 * h];
          const float v1 = acc[mi][ni][2 * h + 1];
          if (e & ROW_FINAL) store_cols(ob + r + c, v0, v1, c, cout);
          else store_cols(qb + r + c, v0, v1, c, cout);
        }
      }
    __syncthreads();  // every row stored; the ring and lists are free
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(sync + 1 + g, 1);
    }
  }
}

// Launch the tile for a row source: one kernel where Cout fits one column
// tile, else the resolve kernel and one MMA block per (row tile, column
// tile); lists is a scratch of B * ceil(n / BM) * LIST ints (unused and may
// be null where cout <= BN).  n output rows an item; n_in input rows
// (default n) and taps offsets of W (default 27) for a strided map.
// Returns the first CUDA error.
template <typename T, class Source>
cudaError_t launch_gather_mma(const void* feats, const void* w,
                              const Source& source, int* lists, void* out,
                              int batch, int n, int cin, int cout,
                              cudaStream_t stream, int n_in = -1,
                              int taps = K3) {
  if (n <= 0 || batch <= 0 || cout <= 0) return cudaSuccess;
  if (n_in < 0) n_in = n;
  constexpr int V = Geometry<T>::VEC;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_a = cin % V == 0 && aligned(feats);
  const int vec_b = cout % V == 0 && aligned(w);
  constexpr size_t smem = smem_bytes<T>();
  const int tiles = (n + BM - 1) / BM;
  const bool split = cout > BN;
  const auto kernel = split ? gather_mma_kernel<T, Source, true>
                            : gather_mma_kernel<T, Source, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (split) {
    resolve_kernel<Source><<<dim3(tiles, 1, batch), THREADS, 0, stream>>>(
        source, lists, n);
  }
  kernel<<<dim3(tiles, split ? (cout + BN - 1) / BN : 1, batch), THREADS,
           smem, stream>>>(static_cast<const T*>(feats),
                           static_cast<const T*>(w), source, lists,
                           static_cast<T*>(out), n, n_in, taps, cin, cout,
                           vec_a, vec_b);
  return cudaGetLastError();
}

// Launch the ordered tile over a level's k3 order of S segments: lists
// [S, B, ceil(n / BM), order_list_ints(27 / S)] and counts [S, B]
// (k3_order.cu), part the f32 partial sums (out itself for f32), sync a
// scratch of 1 + S * B ints that this clears first.  Two blocks an SM
// (what the registers and shared memory allow), at most one an item.  Not
// for the packed mode (Cin * 4 <= BK) nor a strided map.  Returns the
// first CUDA error.
template <typename T, class Tag>
cudaError_t launch_gather_mma_ordered(const void* feats, const void* w,
                                      const int* lists, const int* counts,
                                      float* part, void* out, int* sync,
                                      int segments, int batch, int n,
                                      int cin, int cout,
                                      cudaStream_t stream) {
  if (n <= 0 || batch <= 0 || cout <= 0) return cudaSuccess;
  if (segments < 1 || K3 % segments != 0 || cin * 4 <= BK || n > ROW_INDEX)
    return cudaErrorInvalidValue;
  constexpr int V = Geometry<T>::VEC;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_a = cin % V == 0 && aligned(feats);
  const int vec_b = cout % V == 0 && aligned(w);
  const int tiles = (n + BM - 1) / BM;
  const int ctiles = (cout + BN - 1) / BN;
  const int groups = segments * batch;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(groups) * tiles * ctiles;
  const int blocks = static_cast<int>(
      items < 2LL * sms ? items : 2LL * sms);
  const size_t smem = ordered_smem_bytes<T>() + sizeof(int) * (groups + 1);
  const auto kernel = gather_mma_ordered_kernel<T, Tag>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(sync, 0, sizeof(int) * (1 + groups), stream);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(w), lists, counts,
      part, static_cast<T*>(out), sync, groups, batch, n, tiles, ctiles,
      K3 / segments, cin, cout, vec_a, vec_b);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace mrcc
