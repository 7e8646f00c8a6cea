// int8 tensor-core bodies of B6 and B7 (conv_sk_q8.cu, conv_map_q8.cu), on
// the operands of q8_quantize.cuh: q [rows, cpad] and wq [K, Cout, cpad]
// int8, the channels of every row contiguous, and the f32 column scales m
// of each channel group.  Per group g (gw channels, the last ending at cin;
// ops/conv_q8.py::q8_channel_groups) the int8 products are summed exactly
// in int32, and
//
//   out = sum_g T( f32(int32 sum_g) * m_g[col] )   (in T, in group order)
//
// as the JAX wrappers compute it.  Integer sums are exact and associative,
// so any order of the MMAs gives the plain twin's bits.
//
// The tile is gather_mma.cuh's, in int8: 64 output rows x 128 columns a
// block, eight warps of 32 x 32, mma.sync m16n8k32 s8 x s8 -> s32.  A
// stage holds BK channels (BK / 32 k32 steps; see Ring) of 64 gathered
// rows and of 128 weight rows; a cp.async ring of 16-byte copies,
// zero-filled for a miss or a chunk past the group's end.  Both operands
// are k-contiguous, so non-transposed ldmatrix gives the A and the B
// fragments (ldmatrix.trans moves 16-bit elements and cannot transpose
// int8).  Rows are padded by 16 bytes, which puts the eight rows of an
// ldmatrix phase on 32 distinct banks.
//
//   - gather_mma_q8_kernel: the k3 convs (B6 self-keyed, B7 k3 table) with
//     gather_mma.cuh's row sources and row-tile resolve (27 x 64
//     neighbours, the offsets with a hit, 16-row groups with a hit).  The
//     ring walks (group, offset with a hit, 128-channel chunk); at a
//     group's last step the int32 tile is dequantised with that group's
//     scales into the T-rounded running result and cleared.  Cin <= 8 (the
//     stem) packs its (offset, channel word) pairs along K: ceil(27 cw /
//     32) stages.
//   - list_mma_q8_kernel: B7's down and up convs over per-octant hit lists
//     (hit_lists.cu), as list_mma.cuh does in bf16 / f32: block = (octant
//     k, 64-entry slice of list k, 128-column tile), the ring over the
//     groups' 64-channel chunks.  Up dequantises each group with its
//     octant's scales m[g, k] and stores the fine rows in place
//     (zero_rows_q8_kernel clears the rows no list names); down stores each
//     group's int32 product of each listed fine row into y [G, rows, Cout]
//     and child_sum_q8_kernel sums each coarse row's children in int32,
//     dequantises, and adds the groups in T.
#pragma once

#include <limits.h>

#include "gather_mma.cuh"
#include "list_mma.cuh"

namespace mrcc {
namespace q8 {

using tc::BM;
using tc::BN;
using tc::K3;
using tc::THREADS;

// A ring of STAGES shared-memory stages of BK channels (bytes) each: 64
// gathered rows and 128 weight rows, padded to LD bytes.  The k3 tile
// takes 128-channel stages (3 of them: two blocks an SM), the list GEMM
// 64-channel ones (4): on an H100 the wider stage ran the k3 tile 1.3x
// faster and the narrow list GEMMs (up 256 -> 256) 1.5x slower.
template <int BK_>
struct Ring {
  static constexpr int BK = BK_;
  static constexpr int LD = BK + 16;    // 80 / 144 bytes: conflict-free
  static constexpr int CH = BK / 16;    // 16-byte chunks of a stage row
  static constexpr int WORDS = BK / 4;  // packed mode: channel words
  static constexpr int STAGES = BK >= 128 ? 3 : 4;
  static constexpr int STAGE_BYTES = (BM + BN) * LD;
  static constexpr size_t RING_BYTES =
      static_cast<size_t>(STAGES) * STAGE_BYTES;
};
using TileRing = Ring<128>;
using ListRing = Ring<64>;

// The tile kernel's shared memory: the ring, then gather_mma.cuh's row
// tile lists (nbr [27][BM], klist [28]) and the resolve scratch [27].
__host__ __device__ constexpr size_t tile_smem_bytes() {
  return TileRing::RING_BYTES + sizeof(int) * (tc::LIST + K3);
}

// The channel groups of one conv: ng groups of gw channels (gw a multiple
// of 16), the last one ending at cin; operand rows of cpad bytes.
struct Groups {
  int cin;
  int cpad;
  int gw;
  int ng;

  __device__ __forceinline__ int begin(int g) const { return g * gw; }
  __device__ __forceinline__ int end(int g) const {
    return g == ng - 1 ? cin : (g + 1) * gw;
  }
  __device__ __forceinline__ int chunks(int g, int bk) const {
    return (end(g) - begin(g) + bk - 1) / bk;
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// A stage: As[r][0, BK) = q[src[r], c0 .. c0 + BK) (16-byte chunks; zero
// for src[r] < 0 or a chunk at or past c_end).
template <class R>
__device__ __forceinline__ void load_a(uint8_t* As,
                                       const int8_t* __restrict__ q,
                                       const int* src, int cpad, int c0,
                                       int c_end) {
  for (int e = threadIdx.x; e < BM * R::CH; e += THREADS) {
    const int r = e / R::CH;
    const int c = c0 + (e % R::CH) * 16;
    const int s = src[r];
    const bool ok = s >= 0 && c < c_end;
    tc::cp_async16(As + r * R::LD + (e % R::CH) * 16,
                   ok ? q + static_cast<size_t>(s) * cpad + c : q,
                   ok ? 16 : 0);
  }
}

// B stage: Bs[j][0, BK) = wk[n0 + j, c0 .. c0 + BK) of one [Cout, cpad]
// slice (zero past cout or c_end).
template <class R>
__device__ __forceinline__ void load_b(uint8_t* Bs,
                                       const int8_t* __restrict__ wk,
                                       int cout, int cpad, int c0, int c_end,
                                       int n0) {
  for (int e = threadIdx.x; e < BN * R::CH; e += THREADS) {
    const int j = e / R::CH;
    const int c = c0 + (e % R::CH) * 16;
    const int col = n0 + j;
    const bool ok = col < cout && c < c_end;
    tc::cp_async16(Bs + j * R::LD + (e % R::CH) * 16,
                   ok ? wk + static_cast<size_t>(col) * cpad + c : wk,
                   ok ? 16 : 0);
  }
}

// Packed stages (Cin <= 8): K runs over the words e = k * cw + w (offset
// k, channel word w of cw), WORDS a stage, 4-byte copies.
template <class R>
__device__ __forceinline__ void load_a_packed(uint8_t* As,
                                              const int8_t* __restrict__ fb,
                                              const int* nbr, int cw,
                                              int cpad, int e0) {
  for (int i = threadIdx.x; i < BM * R::WORDS; i += THREADS) {
    const int r = i / R::WORDS;
    const int e = e0 + i % R::WORDS;
    const int s = e < K3 * cw ? nbr[(e / cw) * BM + r] : -1;
    cp_async4(As + r * R::LD + (i % R::WORDS) * 4,
              s >= 0 ? fb + static_cast<size_t>(s) * cpad + (e % cw) * 4 : fb,
              s >= 0 ? 4 : 0);
  }
}

template <class R>
__device__ __forceinline__ void load_b_packed(uint8_t* Bs,
                                              const int8_t* __restrict__ wq,
                                              int cout, int cw, int cpad,
                                              int e0, int n0) {
  for (int i = threadIdx.x; i < BN * R::WORDS; i += THREADS) {
    const int j = i / R::WORDS;
    const int e = e0 + i % R::WORDS;
    const int col = n0 + j;
    const bool ok = e < K3 * cw && col < cout;
    cp_async4(Bs + j * R::LD + (i % R::WORDS) * 4,
              ok ? wq + (static_cast<size_t>(e / cw) * cout + col) * cpad +
                       (e % cw) * 4
                 : wq,
              ok ? 4 : 0);
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage of the warp's 32 x 32 tile: its k32 steps below kmax (the
// stage's channels before the group's end; the steps past it hold
// zeros).  A fragments: the four 8 x 16-byte matrices (rows 0-7 / 8-15,
// bytes 0-15 / 16-31) of each 16-row group; B fragments: Bs is [n][k], so
// matrices (columns 0-7, bytes 0-15 / 16-31) and (columns 8-15, ...) are
// b0 / b1 of two n8 tiles.  on[mi]: some row of the 16-row group mi has a
// hit (uniform over the warp).
template <class R>
__device__ __forceinline__ void mma_stage(int (&acc)[2][4][4],
                                          const uint8_t* As,
                                          const uint8_t* Bs, int wm, int wn,
                                          const bool (&on)[2], int kmax) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < R::BK; kk += 32) {
    if (kk >= kmax) break;  // uniform over the block
    uint32_t a[2][4];
    uint32_t bq[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (on[mi])
        tc::ldmatrix_x4(a[mi], As + (wm * 32 + mi * 16 + (lane & 15)) * R::LD +
                                   kk + (lane >> 4) * 16);
    }
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      tc::ldmatrix_x4(bq[nj], Bs + (wn * 32 + nj * 16 + (lane & 7) +
                                    (lane >> 4) * 8) * R::LD +
                                   kk + ((lane >> 3) & 1) * 16);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (!on[mi]) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_s8(acc[mi][ni], a[mi], bq[ni >> 1][(ni & 1) * 2],
               bq[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// One group's epilogue: res (+)= T(f32(acc) * scale[col]) in T's precision
// (first: res = ...), acc cleared.  scale: the group's (and octant's)
// [cout] row.  The m16n8 accumulator layout: columns n0 + wn * 32 + ni * 8
// + 2t (+ 1).
template <typename T>
__device__ __forceinline__ void dequant(float (&res)[2][4][4],
                                        int (&acc)[2][4][4],
                                        const float* __restrict__ scale,
                                        int n0, int cout, int wn, bool first) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int c = n0 + wn * 32 + ni * 8 + 2 * t;
    const float s0 = c < cout ? __ldg(scale + c) : 0.f;
    const float s1 = c + 1 < cout ? __ldg(scale + c + 1) : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = round_to<T>(
            __fmul_rn(static_cast<float>(acc[mi][ni][q]), q & 1 ? s1 : s0));
        res[mi][ni][q] = first ? v : round_to<T>(__fadd_rn(res[mi][ni][q], v));
        acc[mi][ni][q] = 0;
      }
  }
}

template <typename A>
__device__ __forceinline__ void clear(A (&x)[2][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) x[mi][ni][q] = 0;
}

// ------------------------------------------------------------ k3 tile

// out[b] = the int8 k3 conv of item b over the source's (offset, row)
// hits.  SPLIT: block (x, y, b) reads row tile x's lists (tc::
// resolve_kernel) and computes column tile y; else it resolves its row tile
// and loops over every column tile.  grid (ceil(n / BM), SPLIT ? ceil(cout /
// BN) : 1, B), THREADS threads, tile_smem_bytes() dynamic shared memory.
// q [B, n, cpad], wq [27, cout, cpad], scale [G, cout], out [B, n, cout].
template <typename T, class Source, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 2)
gather_mma_q8_kernel(const int8_t* __restrict__ q,
                     const int8_t* __restrict__ wq,
                     const float* __restrict__ scale, Source source,
                     const int* __restrict__ lists, T* __restrict__ out, int n,
                     Groups gr, int cout) {
  using R = TileRing;
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* ring = smem;
  int* nbr = reinterpret_cast<int*>(ring + TileRing::RING_BYTES);
  int* klist = nbr + K3 * BM;
  int* any = klist + K3 + 1;

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  if (SPLIT) {
    const int* g =
        lists + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * tc::LIST;
    for (int e = threadIdx.x; e < tc::LIST; e += THREADS) nbr[e] = g[e];
    __syncthreads();
  } else {
    tc::resolve_tile(source, b, m0, n, nbr, klist, any);
  }

  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int nk = klist[K3];
  const bool packed = gr.cin <= 8;
  const int cw = (gr.cin + 3) / 4;
  const int ch0 = gr.chunks(0, R::BK);
  const int chl = gr.chunks(gr.ng - 1, R::BK);
  const int per_group = nk * ch0;  // steps of a full group
  const int steps = nk == 0 ? 0
                    : packed ? (K3 * cw + R::WORDS - 1) / R::WORDS
                             : per_group * (gr.ng - 1) + nk * chl;
  const int8_t* fb = q + static_cast<size_t>(b) * n * gr.cpad;
  T* ob = out + static_cast<size_t>(b) * n * cout;

  // step s -> (group g, index j of the offset in klist, chunk c)
  auto locate = [&](int s, int& g, int& j, int& c) {
    g = min(s / per_group, gr.ng - 1);
    const int r = s - g * per_group;
    const int ch = g == gr.ng - 1 ? chl : ch0;
    j = r / ch;
    c = r - j * ch;
  };
  auto load_stage = [&](int s, int n0) {
    uint8_t* As = ring + (s % R::STAGES) * R::STAGE_BYTES;
    uint8_t* Bs = As + BM * R::LD;
    if (packed) {
      load_a_packed<R>(As, fb, nbr, cw, gr.cpad, s * R::WORDS);
      load_b_packed<R>(Bs, wq, cout, cw, gr.cpad, s * R::WORDS, n0);
      return;
    }
    int g, j, c;
    locate(s, g, j, c);
    const int k = klist[j] & 0xff;
    const int c0 = gr.begin(g) + c * R::BK;
    load_a<R>(As, fb, nbr + k * BM, gr.cpad, c0, gr.end(g));
    load_b<R>(Bs, wq + static_cast<size_t>(k) * cout * gr.cpad, cout,
              gr.cpad, c0, gr.end(g), n0);
  };

  const int n_begin = SPLIT ? blockIdx.y * BN : 0;
  const int n_end = SPLIT ? min(cout, n_begin + BN) : cout;
  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    const bool cols = n0 + wn * 32 < cout;
    int acc[2][4][4];
    float res[2][4][4];
    clear(acc);
    clear(res);
#pragma unroll
    for (int s = 0; s < R::STAGES - 1; ++s) {
      if (s < steps) load_stage(s, n0);
      tc::cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      tc::cp_async_wait<R::STAGES - 2>();
      __syncthreads();  // stage s landed; stage s - 1 is free
      if (s + R::STAGES - 1 < steps) load_stage(s + R::STAGES - 1, n0);
      tc::cp_async_commit();
      const uint8_t* As = ring + (s % R::STAGES) * R::STAGE_BYTES;
      int g = 0, j = 0, c = 0;
      if (!packed) locate(s, g, j, c);
      const int mask = packed ? 3 : klist[j] >> (8 + 2 * wm);
      const bool on[2] = {(mask & 1) != 0, (mask & 2) != 0};
      const int kmax = packed ? (K3 * cw - s * R::WORDS) * 4
                              : gr.end(g) - gr.begin(g) - c * R::BK;
      if (cols) mma_stage<R>(acc, As, As + BM * R::LD, wm, wn, on, kmax);
      // the group's last step: its int32 sums -> T, into res
      const bool group_end =
          packed ? s == steps - 1
                 : j == nk - 1 && c == (g == gr.ng - 1 ? chl : ch0) - 1;
      if (group_end && cols)
        dequant<T>(res, acc, scale + static_cast<size_t>(g) * cout, n0, cout,
                   wn, g == 0);
    }
    tc::cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next column tile
    if (cols) tc::store_tile(ob, res, m0, n0, n, cout, wm, wn);
  }
}

// One kernel where Cout fits one column tile, else tc::resolve_kernel and
// one MMA block per (row tile, column tile); lists: B * ceil(n / BM) *
// tc::LIST ints of scratch (may be null where cout <= BN).  Returns the
// first CUDA error.
template <typename T, class Source>
cudaError_t launch_gather_mma(const void* q, const void* wq,
                              const float* scale, const Source& source,
                              int* lists, void* out, int batch, int n,
                              Groups gr, int cout, cudaStream_t stream) {
  if (n <= 0 || batch <= 0 || cout <= 0) return cudaSuccess;
  if (gr.cpad % 16 != 0 || gr.gw % 16 != 0 || !lm::aligned16(q) ||
      !lm::aligned16(wq))
    return cudaErrorInvalidValue;
  constexpr size_t smem = tile_smem_bytes();
  const int tiles = (n + BM - 1) / BM;
  const bool split = cout > BN;
  const auto kernel = split ? gather_mma_q8_kernel<T, Source, true>
                            : gather_mma_q8_kernel<T, Source, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (split) {
    tc::resolve_kernel<Source><<<dim3(tiles, 1, batch), THREADS, 0, stream>>>(
        source, lists, n);
  }
  kernel<<<dim3(tiles, split ? (cout + BN - 1) / BN : 1, batch), THREADS,
           smem, stream>>>(static_cast<const int8_t*>(q),
                           static_cast<const int8_t*>(wq), scale, source,
                           lists, static_cast<T*>(out), n, gr, cout);
  return cudaGetLastError();
}

// ----------------------------------------------------------- list GEMM

// Block = (octant k, slice of BM entries of list k, column tile), found
// from count[] by list_mma.cuh's load_slice (a block past the counts
// exits).  UP: out [out_rows, cout] T, each group dequantised with
// scale[g, k] ([G, taps, cout]); else (down) y [G, out_rows, cout] int32,
// each group's product stored as it ends.  grid (slices * ceil(cout /
// BN)), THREADS threads, ListRing::RING_BYTES dynamic shared memory.
template <typename T, bool UP>
__global__ void __launch_bounds__(THREADS, 2)
list_mma_q8_kernel(const int8_t* __restrict__ q,
                   const int8_t* __restrict__ wq,
                   const float* __restrict__ scale,
                   const int* __restrict__ src, const int* __restrict__ dst,
                   const int* __restrict__ count, T* __restrict__ out,
                   int* __restrict__ y, int taps, int total, int out_rows,
                   Groups gr, int cout) {
  using R = ListRing;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int rows[2][BM];  // the slice's src and dst rows, -1 past it
  __shared__ int head[3];      // octant, first entry, entries
  uint8_t* ring = smem;

  const int tiles_n = (cout + BN - 1) / BN;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  // a slice past the lists (uniform over the block)
  if (!lm::load_slice(src, dst, count, taps, total, blockIdx.x / tiles_n,
                      rows, head))
    return;
  const int k = head[0];
  const int m = head[2];

  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const bool on[2] = {wm * 32 < m, wm * 32 + 16 < m};
  const bool cols = n0 + wn * 32 < cout;
  const int8_t* wk = wq + static_cast<size_t>(k) * cout * gr.cpad;
  const int ch0 = gr.chunks(0, R::BK);
  const int steps = ch0 * (gr.ng - 1) + gr.chunks(gr.ng - 1, R::BK);
  auto locate = [&](int s, int& g, int& c) {
    g = min(s / ch0, gr.ng - 1);
    c = s - g * ch0;
  };
  auto load_stage = [&](int s) {
    uint8_t* As = ring + (s % R::STAGES) * R::STAGE_BYTES;
    int g, c;
    locate(s, g, c);
    const int c0 = gr.begin(g) + c * R::BK;
    load_a<R>(As, q, rows[0], gr.cpad, c0, gr.end(g));
    load_b<R>(As + BM * R::LD, wk, cout, gr.cpad, c0, gr.end(g), n0);
  };

  int acc[2][4][4];
  float res[2][4][4];
  clear(acc);
  clear(res);
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int s = 0; s < R::STAGES - 1; ++s) {
    if (s < steps) load_stage(s);
    tc::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    tc::cp_async_wait<R::STAGES - 2>();
    __syncthreads();  // stage s landed; stage s - 1 is free
    if (s + R::STAGES - 1 < steps) load_stage(s + R::STAGES - 1);
    tc::cp_async_commit();
    const uint8_t* As = ring + (s % R::STAGES) * R::STAGE_BYTES;
    int g, c;
    locate(s, g, c);
    if (cols)
      mma_stage<R>(acc, As, As + BM * R::LD, wm, wn, on,
                   gr.end(g) - gr.begin(g) - c * R::BK);
    if (!cols || c != gr.chunks(g, R::BK) - 1) continue;
    if (UP) {
      dequant<T>(res, acc, scale + (static_cast<size_t>(g) * taps + k) * cout,
                 n0, cout, wn, g == 0);
      continue;
    }
    // down: the group's int32 products of the slice's fine rows
    int* yg = y + static_cast<size_t>(g) * out_rows * cout;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = wm * 32 + mi * 16 + gq + h * 8;
        const int r = lr < m ? rows[1][lr] : -1;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = n0 + wn * 32 + ni * 8 + 2 * t;
          if (r >= 0 && col < cout) {
            int* p = yg + static_cast<size_t>(r) * cout + col;
            if ((cout & 1) == 0) {
              *reinterpret_cast<int2*>(p) =
                  make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
            } else {
              p[0] = acc[mi][ni][2 * h];
              if (col + 1 < cout) p[1] = acc[mi][ni][2 * h + 1];
            }
          }
          acc[mi][ni][2 * h] = 0;
          acc[mi][ni][2 * h + 1] = 0;
        }
      }
  }
  tc::cp_async_wait<0>();
  if (UP && cols)
    tc::store_rows(
        out, res, [&](int lr) { return lr < m ? rows[1][lr] : -1; }, n0,
        cout, wm, wn);
}

// The list GEMM: UP into out (T), else into y (int32).  The grid is sized
// from the shapes (each stored row lies in at most one list: at most
// out_rows entries), no host sync.  Returns the first CUDA error.
template <typename T, bool UP>
cudaError_t launch_list_gemm(const void* q, const void* wq, const float* scale,
                             const int* src, const int* dst, const int* count,
                             void* out, int* y, int taps, int total,
                             int out_rows, Groups gr, int cout,
                             cudaStream_t stream) {
  if (taps <= 0 || total <= 0 || out_rows <= 0 || cout <= 0)
    return cudaSuccess;
  if (gr.cpad % 16 != 0 || gr.gw % 16 != 0 || !lm::aligned16(q) ||
      !lm::aligned16(wq))
    return cudaErrorInvalidValue;
  constexpr size_t smem = ListRing::RING_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      list_mma_q8_kernel<T, UP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long per_list = (static_cast<long long>(total) + BM - 1) / BM;
  long long slices = (static_cast<long long>(out_rows) + BM - 1) / BM + taps;
  if (slices > taps * per_list) slices = taps * per_list;
  const long long blocks = slices * ((cout + BN - 1) / BN);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  list_mma_q8_kernel<T, UP><<<static_cast<unsigned>(blocks), THREADS, smem,
                              stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(wq), scale,
      src, dst, count, static_cast<T*>(out), y, taps, total, out_rows, gr,
      cout);
  return cudaGetLastError();
}

// ------------------------------------------------------ down: child sum

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The down conv's second pass, bound by bytes:
//   out[b, p, :] = sum_g T( f32( sum_{k < 8} child_hit[k, b, p]
//                  * y[g, b * n_in + child_idx[k, b, p], :] ) * scale[g, :] )
// the child sum in int32 (exact), the groups added in T in group order.
// One warp a coarse row: lanes 0-7 read its eight map entries, then the
// warp walks its columns, V at a time (16-byte loads for V = 4).
template <typename T, int V>
__global__ void __launch_bounds__(256)
child_sum_q8_kernel(const int* __restrict__ y, const float* __restrict__ scale,
                    const int* __restrict__ child_idx,
                    const uint8_t* __restrict__ child_hit, T* __restrict__ out,
                    int batch, int n_in, int n_out, int cout, int ng) {
  const int lane = threadIdx.x & 31;
  const long long rows = static_cast<long long>(batch) * n_out;
  const size_t plane = static_cast<size_t>(batch) * n_in * cout;
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
    long long child[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int jk = __shfl_sync(0xffffffffu, j, k);
      child[k] = jk < 0 ? -1 : (base + jk) * cout;
    }
    T* o = out + row * cout;
    for (int c = lane * V; c < cout; c += 32 * V) {
      float res[V];
      for (int g = 0; g < ng; ++g) {
        const int* yg = y + g * plane;
        int acc[V];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (child[k] < 0) continue;
          if constexpr (V == 4) {
            const int4 t = *reinterpret_cast<const int4*>(yg + child[k] + c);
            acc[0] += t.x;
            acc[1] += t.y;
            acc[2] += t.z;
            acc[3] += t.w;
          } else {
            acc[0] += yg[child[k] + c];
          }
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float d = round_to<T>(__fmul_rn(
              static_cast<float>(acc[v]),
              __ldg(scale + static_cast<size_t>(g) * cout + c + v)));
          res[v] = g == 0 ? d : round_to<T>(__fadd_rn(res[v], d));
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) store_out(o + c + v, res[v]);
    }
  }
}

// The up conv's rows that no list names (not row_ok, or an octant outside
// 0..7: padding rows and the children of overflowed parents) are cleared:
// one warp a row of out [rows, cout].
template <typename T>
__global__ void __launch_bounds__(256)
zero_rows_q8_kernel(const uint8_t* __restrict__ row_ok,
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

template <typename T>
cudaError_t launch_child_sum(const int* y, const float* scale,
                             const int* child_idx, const uint8_t* child_hit,
                             void* out, int batch, int n_in, int n_out,
                             int cout, int ng, cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * n_out;
  if (rows <= 0 || cout <= 0) return cudaSuccess;
  const bool vec = cout % 4 == 0 && lm::aligned16(y);
  const auto kernel =
      vec ? child_sum_q8_kernel<T, 4> : child_sum_q8_kernel<T, 1>;
  kernel<<<lm::row_blocks(rows), 256, 0, stream>>>(
      y, scale, child_idx, child_hit, static_cast<T*>(out), batch, n_in,
      n_out, cout, ng);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_zero_rows(const uint8_t* row_ok, const int* octant,
                             void* out, long long rows, int cout,
                             cudaStream_t stream) {
  if (rows <= 0 || cout <= 0) return cudaSuccess;
  zero_rows_q8_kernel<T><<<lm::row_blocks(rows), 256, 0, stream>>>(
      row_ok, octant, static_cast<T*>(out), rows, cout);
  return cudaGetLastError();
}

}  // namespace q8
}  // namespace mrcc
