// The weight-gradient kernels (conv_dw.cu):
//
//   dW[k] = sum over the hits of offset k of feats[fidx]^T (x) g[gidx]
//                                              -> [K, Cin, Cout] f32,
//
// a gather-GEMM whose product dimension is the hits of offset k and whose
// output is the small [Cin, Cout] block.  The hits come listed: per
// offset, the (feats row, g row) pairs in row order with their count, the
// lists of the conv's map (hit_lists.cu: the self-keyed search or the k3
// tables of a level, the down conv's child map, the up conv's parent /
// octant map), built once a map and shared with every conv over it.
//
// Bound on the card: 2 * hits * Cin * Cout operations against one gathered
// feature row and one g row a hit; the decoder's widths (256-416) are
// bound by operations, the stem (3 x 32) and the narrow down convs by
// bytes.  Two stages, at most two launches a call:
//
// 1. dw_mma_kernel: one block per (dW tile, slot).  The slots spread over
//    the offsets by their hit counts on the card (slot_plan; no host
//    sync), so that every block has about the same work; a slot splits
//    its offset's list evenly, and one without hits writes a zero partial.
//    The GEMM computes dW[k] or dW[k]^T so that the narrower of Cin and
//    Cout is the n8 side of the MMA.  A block's tile is 128 (or, where the
//    wider width is at most 128, 64) x 128; eight warps, 2 x 4, own 64 x 32
//    (or 32 x 32) outputs each in f32 registers.  A ring of shared-memory
//    stages of 32 listed hits gathers both operands as [hit][channel] rows
//    by 16-byte cp.async (scalar loads where a width is not whole 16-byte
//    chunks), zero-filled past the slot and past the width; the source
//    rows of each stage arrive earlier, by 4-byte cp.async, in a small
//    shared ring.
//    - bf16: mma.sync m16n8k16 with f32 accumulation; both fragments by
//      ldmatrix.trans from the hit-major tiles;
//    - f32: mma.sync m16n8k8 in TF32 as a 3xTF32 split (gather_mma.cuh),
//      each k8 step's three products summed from zero and added in f32
//      (the tensor cores' accumulation truncates, and the product
//      dimension runs to ~10^5 hits: one accumulator drifted 3e-5).
//    Warps whose 16-row / 8-column groups lie past the widths skip their
//    MMAs; where fewer than half the warps hold outputs (the stem, the
//    32-wide levels), replicas of them split each stage's k steps and
//    their sums are added in replica order.  Blocks are numbered
//    tile-fastest, so the blocks that read one slot's rows run together
//    and share them in L2.
// 2. dw_reduce: each offset's slot partials summed in slot order.
//
// Determinism: no float atomics; the lists are the same bits for the same
// inputs, and every sum runs in a fixed order.  The self-keyed search and
// the k3 tables of one level give the same lists, hence the same dW bits.
#pragma once

#include "gather_mma.cuh"

namespace mrcc {

namespace dw {

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::zero_of;

constexpr int BN = 128;  // N side of a block's dW tile (the narrower width)
constexpr int BH = 32;   // hits a stage
constexpr int THREADS = 256;
constexpr int LDB = BN + 8;

// MI: 16-row groups of a warp's M side; a block's M side is 32 MI (warps
// 2 x 4, each MI * 16 x 32 outputs).  Row pitches of 8 elements past a
// multiple of 32 (f32) or of 64 (bf16: 16 bytes past 128) put the f32
// fragment loads and every ldmatrix phase on 32 distinct banks.  Two
// blocks a multiprocessor: bf16 with 4 stages, f32 with 3.
template <int MI>
constexpr int BM = 32 * MI;
template <int MI>
constexpr int LDA = BM<MI> + 8;
template <typename T>
constexpr int STAGES = sizeof(T) == 2 ? 4 : 3;
template <typename T>
constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte chunk

template <typename T, int MI>
__host__ __device__ constexpr int stage_elems() {
  return BH * (LDA<MI> + LDB);
}

template <typename T, int MI>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * STAGES<T> * stage_elems<T, MI>();
}

// The columns a stage stages: the power of two from 16 up that covers x
// (at most the tile's extent).
__device__ __forceinline__ int stage_cols(int x, int extent) {
  int p = 16;
  while (p < x && p < extent) p <<= 1;
  return p;
}

// One operand's share of a stage: S[r][c] = base[rows[r], c0 + c] for
// r < BH, c < cols (a power of two from 16 to EXTENT), 0 where rows[r] <
// 0 (past the slot) or c0 + c >= width.  rows: the stage's source rows in
// shared memory.  vec (width a whole number of 16-byte chunks, base
// 16-byte aligned): each thread copies the chunk of column c of rows r0,
// r0 + rstep, ... by cp.async (cols / VEC divides THREADS, so c stays
// fixed); else scalar loads.
template <typename T, int EXTENT, int LD>
struct RowGather {
  static constexpr int V = VEC<T>;
  static constexpr int J = BH * EXTENT / V / THREADS;
  const T* __restrict__ base;
  int width, c0, cols, r0, rstep, c;
  bool vec, col_ok;

  __device__ __forceinline__ RowGather(const T* base_, int width_, int c0_,
                                       int cols_, bool vec_)
      : base(base_), width(width_), c0(c0_), cols(cols_),
        r0(threadIdx.x / (cols_ / V)), rstep(THREADS / (cols_ / V)),
        c(threadIdx.x % (cols_ / V) * V), vec(vec_),
        col_ok(c0_ + c < width_) {}

  __device__ __forceinline__ void issue(T* S, const int* rows) const {
    if (vec) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int r = r0 + j * rstep;
        if (r >= BH) break;
        const int row = rows[r];
        const bool ok = row >= 0 && col_ok;
        cp_async16(S + r * LD + c,
                   ok ? base + static_cast<size_t>(row) * width + c0 + c
                      : base,
                   ok ? 16 : 0);
      }
      return;
    }
    for (int e = threadIdx.x; e < BH * cols; e += THREADS) {
      const int r = e / cols;
      const int cc = e % cols;
      const int row = rows[r];
      S[r * LD + cc] = (row >= 0 && c0 + cc < width)
                           ? base[static_cast<size_t>(row) * width + c0 + cc]
                           : zero_of<T>();
    }
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// mma.sync m16n8k8 TF32 as a pure function of its operands (the compiler
// may interleave independent products).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The k16 (bf16) or k8 (f32) steps j = rep, rep + reps, ... of one stage
// (BH hits) for the warp's MI * 16 x 32 tile; rep / reps: the warp's
// replica of its tile (see dw_mma_kernel).  Am [hit][BM + 8], Bn [hit][BN +
// 8].  bf16: both fragments by ldmatrix.trans from the hit-major tiles.
template <int MI>
__device__ __forceinline__ void mma_stage(float (&acc)[MI][4][4],
                                          const __nv_bfloat16* Am,
                                          const __nv_bfloat16* Bn, int wm,
                                          int wn, const bool (&on_m)[MI],
                                          const bool (&on_n)[4], int rep,
                                          int reps) {
  constexpr int LDA = dw::LDA<MI>;
  const int lane = threadIdx.x & 31;
  for (int kk = rep * 16; kk < BH; kk += reps * 16) {
    uint32_t a[MI][4];
    uint32_t bq[2][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      if (on_m[mi])  // matrices (m 0-7 | 8-15) x (k 0-7 | 8-15), transposed
        tc::ldmatrix_x4_trans(
            a[mi], Am + (kk + (lane & 7) + (lane >> 4) * 8) * LDA +
                       wm * MI * 16 + mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      if (on_n[2 * nj])
        tc::ldmatrix_x4_trans(
            bq[nj], Bn + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB +
                        wn * 32 + nj * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      if (!on_m[mi]) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        if (on_n[ni])
          tc::mma_bf16(acc[mi][ni], a[mi], bq[ni >> 1][(ni & 1) * 2],
                       bq[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
}

// f32: each k8 step is 3xTF32.  The B fragments are split once a step;
// each 16-row group's A fragment is split just before its twelve products
// (few registers live), the four column chains side by side (each of the
// three products of a chain waits on the one before it), summed from zero
// and added to acc in f32.
template <int MI>
__device__ __forceinline__ void mma_stage(float (&acc)[MI][4][4],
                                          const float* Am, const float* Bn,
                                          int wm, int wn,
                                          const bool (&on_m)[MI],
                                          const bool (&on_n)[4], int rep,
                                          int reps) {
  constexpr int LDA = dw::LDA<MI>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int kk = rep * 8; kk < BH; kk += reps * 8) {
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      if (!on_n[ni]) continue;
      const float* p = Bn + (kk + t) * LDB + wn * 32 + ni * 8 + g;
      tc::split_tf32(p[0], bh[ni][0], bl[ni][0]);
      tc::split_tf32(p[4 * LDB], bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      if (!on_m[mi]) continue;
      // A[m][h] = Am[h][m]: rows g / g + 8, hits t / t + 4
      const float* p = Am + (kk + t) * LDA + wm * MI * 16 + mi * 16 + g;
      uint32_t ah[4], al[4];
      tc::split_tf32(p[0], ah[0], al[0]);
      tc::split_tf32(p[8], ah[1], al[1]);
      tc::split_tf32(p[4 * LDA], ah[2], al[2]);
      tc::split_tf32(p[4 * LDA + 8], ah[3], al[3]);
      float d[4][4] = {};
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        if (on_n[ni]) mma_tf32(d[ni], al, bh[ni][0], bh[ni][1]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        if (on_n[ni]) mma_tf32(d[ni], ah, bl[ni][0], bl[ni][1]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        if (on_n[ni]) mma_tf32(d[ni], ah, bh[ni][0], bh[ni][1]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        if (on_n[ni])
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][ni][q] += d[ni][q];
    }
  }
}

// The slots of a launch spread over the offsets by their hit counts:
// offset k gets n_k = 1 + floor((slots - K) * count[k] / total) slots
// (every offset one at least; sum n_k <= slots), numbered from start_k =
// sum_{k' < k} n_k', and slot j of k takes hits [count[k] * j / n_k,
// count[k] * (j + 1) / n_k) of its list.  With slots == K each offset has
// one slot.  Called by the whole block: fills plan[2 k] = start_k,
// plan[2 k + 1] = n_k (plan holds 3 * K3 ints; the last K3 are scratch).
__device__ __forceinline__ void slot_plan(const int* __restrict__ count,
                                          int taps, int slots, int* plan) {
  int* cnt = plan + 2 * tc::K3;
  if (threadIdx.x < taps) cnt[threadIdx.x] = __ldg(count + threadIdx.x);
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int k = 0; k < taps; ++k) total += cnt[k];
    int start = 0;
    for (int k = 0; k < taps; ++k) {
      const int n = 1 + (total > 0 ? static_cast<int>(
                                         static_cast<long long>(slots - taps) *
                                         cnt[k] / total)
                                   : 0);
      plan[2 * k] = start;
      plan[2 * k + 1] = n;
      start += n;
    }
  }
  __syncthreads();
}

// grid (ceil(M / BM) * ceil(N / BN), slots), THREADS threads,
// smem_bytes<T, MI>() dynamic shared memory.  pm / pn: the M-side and
// N-side operands ([rows, M] and [rows, N]); lists [2, K, total] (fidx,
// gidx); swap: the M side is g (the block computes dW[k]^T).  out: part
// [slots, cin, cout] or, where slots == K, dW itself.
template <typename T, int MI>
__global__ void __launch_bounds__(THREADS, 2)
dw_mma_kernel(const T* __restrict__ pm, const T* __restrict__ pn,
              const int* __restrict__ lists, const int* __restrict__ count,
              float* __restrict__ out, int taps, int total, int m_width,
              int n_width, int swap, int vec_m, int vec_n) {
  constexpr int BM = dw::BM<MI>;
  constexpr int STAGES = dw::STAGES<T>;
  constexpr int SE = stage_elems<T, MI>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int plan[3 * tc::K3];
  T* ring = reinterpret_cast<T*>(smem);

  slot_plan(count, taps, gridDim.y, plan);
  const int slot = blockIdx.y;
  int k = 0;
  while (k < taps && slot >= plan[2 * k] + plan[2 * k + 1]) ++k;
  if (k == taps) return;  // a slot no offset takes
  const int part = slot - plan[2 * k];
  const int parts = plan[2 * k + 1];

  const int tiles_n = (n_width + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int m_cols = stage_cols(m_width - m0, BM);
  const int n_cols = stage_cols(n_width - n0, BN);
  const int* fidx = lists + static_cast<size_t>(k) * total;
  const int* gidx = lists + static_cast<size_t>(taps + k) * total;

  const long long cnt = plan[2 * tc::K3 + k];
  const int h_begin = static_cast<int>(cnt * part / parts);
  const int h_end = static_cast<int>(cnt * (part + 1) / parts);
  const int steps = (h_end - h_begin + BH - 1) / BH;

  // Warps (wm, wn) of the 2 x 4 layout whose tile holds outputs: `active`
  // of them.  Where fewer than half hold any (narrow widths), the block
  // runs `reps` replicas of those warps, replica r taking the k steps r,
  // r + reps, ... of every stage; the replicas' sums are added in replica
  // order at the end.
  const int warp = threadIdx.x >> 5;
  const int am = min(2, (m_width - m0 + MI * 16 - 1) / (MI * 16));
  const int an = min(4, (n_width - n0 + 31) / 32);
  const int active = am * an;
  const int reps = active <= 2 ? 4 : active <= 4 ? 2 : 1;
  const int rep = warp / active;
  const int wm = (warp % active) / an;
  const int wn = (warp % active) % an;
  bool on_m[MI], on_n[4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
    on_m[i] = rep < reps && m0 + (wm * MI + i) * 16 < m_width;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    on_n[i] = rep < reps && n0 + wn * 32 + i * 8 < n_width;

  // The source rows of stage s (both operands) sit in rows_at[s % NI],
  // read by cp.async STAGES - 1 iterations before its copies are issued
  // (so that the wait that lands a stage has landed them): no copy waits
  // on an index load, and no index is held in registers.
  constexpr int NI = 2 * STAGES - 2;
  __shared__ int rows_at[NI][2][BH];
  const int* list_m = swap ? gidx : fidx;
  const int* list_n = swap ? fidx : gidx;
  auto fetch = [&](int s, bool async) {
    if (threadIdx.x >= 2 * BH) return;
    const int side = threadIdx.x / BH;
    const int h = h_begin + s * BH + threadIdx.x % BH;
    int* dst = &rows_at[s % NI][side][threadIdx.x % BH];
    const int* src = (side ? list_n : list_m) + h;
    if (h >= h_end)
      *dst = -1;
    else if (async)
      cp_async4(dst, src);
    else
      *dst = __ldg(src);
  };
  RowGather<T, BM, LDA<MI>> ga(pm, m_width, m0, m_cols, vec_m);
  RowGather<T, BN, LDB> gb(pn, n_width, n0, n_cols, vec_n);
  auto issue = [&](int s) {  // stage s's copies
    T* Am = ring + (s % STAGES) * SE;
    ga.issue(Am, rows_at[s % NI][0]);
    gb.issue(Am + BH * LDA<MI>, rows_at[s % NI][1]);
  };

  float acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
  for (int s = 0; s < NI; ++s) fetch(s, false);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    // stage s landed, and the rows of stage s + STAGES - 1; stage s - 1
    // and the rows of stage s (copies issued long ago) are free
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < steps) issue(s + STAGES - 1);
    fetch(s + NI, true);
    cp_async_commit();
    const T* Am = ring + (s % STAGES) * SE;
    mma_stage<MI>(acc, Am, Am + BH * LDA<MI>, wm, wn, on_m, on_n, rep,
                  reps);
  }
  cp_async_wait<0>();
  const int lane = threadIdx.x & 31;
  if (reps > 1) {  // replica r > 0 hands its sums to replica 0 (the ring)
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
    constexpr int PER = MI * 16;  // accumulators a lane
    if (rep > 0 && rep < reps) {
      float* p =
          red + (((rep - 1) * active + warp % active) * 32 + lane) * PER;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            p[(mi * 4 + ni) * 4 + q] = acc[mi][ni][q];
    }
    __syncthreads();
    if (rep > 0) return;
    for (int r = 1; r < reps; ++r) {
      const float* p = red + (((r - 1) * active + warp) * 32 + lane) * PER;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[mi][ni][q] += p[(mi * 4 + ni) * 4 + q];
    }
  } else if (rep > 0) {
    return;
  }

  // rows m0 + (wm * MI + mi) * 16 + g (+ 8), columns n0 + wn * 32 + ni * 8
  // + 2t (+ 1): the m16n8 accumulator layout
  const int cin = swap ? n_width : m_width;
  const int cout = swap ? m_width : n_width;
  float* dst = out + static_cast<size_t>(gridDim.y == taps ? k : slot) *
                         cin * cout;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + (wm * MI + mi) * 16 + (lane >> 2) + (q >> 1) * 8;
        const int n = n0 + wn * 32 + ni * 8 + 2 * (lane & 3) + (q & 1);
        if (m >= m_width || n >= n_width) continue;
        const size_t at = swap ? static_cast<size_t>(n) * cout + m
                               : static_cast<size_t>(m) * cout + n;
        dst[at] = acc[mi][ni][q];
      }
}

// out[k, e] = sum_{j < n_k} part[start_k + j, e], in slot order (the plan
// of dw_mma_kernel).  size = cin * cout.
__global__ void dw_reduce(const float* __restrict__ part,
                          const int* __restrict__ count,
                          float* __restrict__ out, int taps, int slots,
                          long long size) {
  __shared__ int plan[3 * tc::K3];
  slot_plan(count, taps, slots, plan);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < taps * size; e += stride) {
    const int k = static_cast<int>(e / size);
    const float* p = part + plan[2 * k] * size + e % size;
    float s = 0.f;
    for (int j = 0; j < plan[2 * k + 1]; ++j) s += p[j * size];
    out[e] = s;
  }
}

// The MMA kernel and the reduction for one warp tile.
template <typename T, int MI>
cudaError_t launch_gemm(const T* pm, const T* pn, const int* lists,
                        const int* count, float* part, float* out, int k,
                        int total, int m_width, int n_width, bool swap,
                        int slots, cudaStream_t stream) {
  constexpr int V = VEC<T>;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_m = m_width % V == 0 && aligned(pm);
  const int vec_n = n_width % V == 0 && aligned(pn);
  constexpr size_t smem = smem_bytes<T, MI>();
  const cudaError_t err = cudaFuncSetAttribute(
      dw_mma_kernel<T, MI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = ((m_width + BM<MI> - 1) / BM<MI>) *
                    ((n_width + BN - 1) / BN);
  dw_mma_kernel<T, MI><<<dim3(tiles, slots), THREADS, smem, stream>>>(
      pm, pn, lists, count, slots == k ? out : part, k, total, m_width,
      n_width, swap, vec_m, vec_n);
  if (slots > k) {
    const long long size = static_cast<long long>(m_width) * n_width;
    const long long want = (k * size + 255) / 256;
    const int blocks = static_cast<int>(want < 4096 ? want : 4096);
    dw_reduce<<<blocks, 256, 0, stream>>>(part, count, out, k, slots, size);
  }
  return cudaGetLastError();
}

}  // namespace dw

// The warp tile's M side: MI = 4 (64 x 32 a warp, 128 x 128 a block)
// where the wider width passes DW_MI_SPLIT, else MI = 2 (32 x 32, 64 x
// 128; measured faster at 128 x 128, where it gives twice the blocks).
// Both run two blocks a multiprocessor (the f32 tile in 128 registers a
// thread: its A fragments are split just before use).
constexpr int DW_MI_SPLIT = 128;

// dW [k, cin, cout] f32 into out from the lists [2, k, total] and count
// [k] of hit_lists.cu; with slots > k, part [slots, cin, cout] f32 holds
// the slot partials.  Launches: the MMA kernel, and the slot reduction
// where slots > k.  Returns the first CUDA error.
template <typename T>
int dw_launch(const void* feats, const void* g, const int* lists,
              const int* count, float* part, float* out, int k, int total,
              int cin, int cout, int slots, cudaStream_t stream) {
  if (k <= 0 || cin <= 0 || cout <= 0 || slots < k) return 0;
  if (total <= 0)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(k) * cin * cout * sizeof(float), stream));
  const bool swap = cin < cout;  // the narrower width on the n8 side
  const T* pm = static_cast<const T*>(swap ? g : feats);
  const T* pn = static_cast<const T*>(swap ? feats : g);
  const int m_width = swap ? cout : cin;
  const int n_width = swap ? cin : cout;
  if (m_width > DW_MI_SPLIT)
    return static_cast<int>(dw::launch_gemm<T, 4>(
        pm, pn, lists, count, part, out, k, total, m_width, n_width, swap,
        slots, stream));
  return static_cast<int>(dw::launch_gemm<T, 2>(
      pm, pn, lists, count, part, out, k, total, m_width, n_width, swap,
      slots, stream));
}

}  // namespace mrcc
