// B10 — nearest valid target of every template point (the ICP inner loop).
//
// Replaces: mrcc_tpu/ops/nn_pallas.py::nn_search_pallas (_nn_kernel).
//
//   per item b and template point i, over targets j:
//     d2[j] = (|a_i|^2 - 2 (a_i . b'_j)) + s_j,
//     b'_j = valid_j ? b_j : 0,   s_j = valid_j ? |b_j|^2 : 1e30,
//     idx[b, i] = smallest j with d2[j] == min_j d2[j],  d2[b, i] = that min.
//
// This is the TPU kernel's own formula (not the |a|^2 + |b|^2 - 2ab of the
// plain ICP), including its 1e30 for invalid targets.  The arithmetic is
// fixed: |v|^2 = (x*x + y*y) + z*z, a.b = (ax*bx + ay*by) + az*bz, each
// product and sum rounded on its own (__fmul_rn / __fadd_rn, no contracted
// FMA), so the plain twin's element-wise PyTorch expression in the same
// order gives the same bits.
//
// Bound on the card: operations, M * N distance evaluations of ~8 f32
// operations each (the inputs are 16 bytes a point).  K = 3 is too small for
// tensor cores.  At the ICP's shapes (B x 1024 template points over 2048 to
// 8192 targets) one thread per template point gave 8 to 32 blocks on 132
// SMs.  Design:
//   - the grid is (template tiles, target splits S, items).  The wrapper
//     picks S (ops/nn.py nn_splits) so that at least two blocks an SM are in
//     flight at the ICP's shapes; a block stages its split's targets through
//     shared memory as (x, y, z, s) float4s, which every thread reads at the
//     same address (a broadcast);
//   - each thread holds POINTS template points in registers, so one shared
//     load serves POINTS distance evaluations;
//   - each split keeps the first minimum of its targets (ascending j,
//     replaced only on a strictly smaller d2), which is the least (d2, j)
//     pair in lexicographic order.  Where S > 1 it writes (j, d2) to a
//     [S, B, M] scratch and a second kernel takes the least pair over the
//     splits: a block holds 32 template points, 8 warps each read every
//     8th split of them (coalesced, several loads in flight), and warp 0
//     combines the 8 in shared memory.  Every split evaluates d2 with the
//     same expression and the lexicographic minimum does not depend on the
//     order pairs meet, so the result has the bits of one sequential scan
//     (no atomics: blocks may run in any order).  Where S = 1 the split
//     kernel writes the outputs itself.  Inputs are finite (a NaN d2 is
//     never taken).

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // ops/nn.py NN_THREADS
constexpr int POINTS = 4;     // ops/nn.py NN_POINTS: template points a thread
constexpr int TILE_M = THREADS * POINTS;
constexpr int CHUNK = 1024;   // targets staged at a time (16 KB)
constexpr int MERGE_POINTS = 32;  // template points a merge block
constexpr int MERGE_WAYS = 8;     // warps a merge block, each every 8th split

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// Block (tile, split s, item b): the first minimum over targets
// [s * len, min((s + 1) * len, n)) of POINTS template points a thread.
__global__ void __launch_bounds__(THREADS)
nn_split_kernel(const float* __restrict__ tmpl,
                const float* __restrict__ target,
                const uint8_t* __restrict__ mask, int* __restrict__ part_idx,
                float* __restrict__ part_d2, int batch, int m, int n,
                int len) {
  __shared__ float4 tile[CHUNK];
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int i0 = blockIdx.x * TILE_M + threadIdx.x;
  const int j_begin = s * len;
  const int j_end = min(j_begin + len, n);

  float ax[POINTS], ay[POINTS], az[POINTS], sqs[POINTS], best[POINTS];
  int best_j[POINTS];
#pragma unroll
  for (int p = 0; p < POINTS; ++p) {
    const int i = min(i0 + p * THREADS, m - 1);
    const float* a = tmpl + (static_cast<size_t>(b) * m + i) * 3;
    ax[p] = a[0];
    ay[p] = a[1];
    az[p] = a[2];
    sqs[p] = sq_norm(ax[p], ay[p], az[p]);
    best[p] = CUDART_INF_F;
    best_j[p] = j_begin;
  }
  const float* tb = target + static_cast<size_t>(b) * n * 3;
  const uint8_t* mb = mask + static_cast<size_t>(b) * n;

  for (int c0 = j_begin; c0 < j_end; c0 += CHUNK) {
    const int cnt = min(CHUNK, j_end - c0);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt; e += THREADS) {
      const int j = c0 + e;
      const bool ok = mb[j] != 0;
      const float x = ok ? tb[3 * j] : 0.f;
      const float y = ok ? tb[3 * j + 1] : 0.f;
      const float z = ok ? tb[3 * j + 2] : 0.f;
      tile[e] = make_float4(x, y, z, ok ? sq_norm(x, y, z) : 1e30f);
    }
    __syncthreads();
    for (int e = 0; e < cnt; ++e) {
      const float4 t = tile[e];
#pragma unroll
      for (int p = 0; p < POINTS; ++p) {
        const float st = __fadd_rn(
            __fadd_rn(__fmul_rn(ax[p], t.x), __fmul_rn(ay[p], t.y)),
            __fmul_rn(az[p], t.z));
        const float d = __fadd_rn(__fsub_rn(sqs[p], __fmul_rn(2.f, st)), t.w);
        if (d < best[p]) {
          best[p] = d;
          best_j[p] = c0 + e;
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < POINTS; ++p) {
    const int i = i0 + p * THREADS;
    if (i < m) {
      const size_t o = (static_cast<size_t>(s) * batch + b) * m + i;
      part_idx[o] = best_j[p];
      part_d2[o] = best[p];
    }
  }
}

// (d, j) before (best, best_j) in lexicographic order.
__device__ __forceinline__ bool before(float d, int j, float best,
                                       int best_j) {
  return d < best || (d == best && j < best_j);
}

// The least (d2, j) pair of each (item, template point) over the splits.
__global__ void __launch_bounds__(MERGE_POINTS * MERGE_WAYS)
nn_merge_kernel(const int* __restrict__ part_idx,
                const float* __restrict__ part_d2, int* __restrict__ idx,
                float* __restrict__ d2, int bm, int splits) {
  __shared__ float s_d[MERGE_WAYS][MERGE_POINTS];
  __shared__ int s_j[MERGE_WAYS][MERGE_POINTS];
  const int lane = threadIdx.x % MERGE_POINTS;
  const int way = threadIdx.x / MERGE_POINTS;
  const int e = blockIdx.x * MERGE_POINTS + lane;
  float best = CUDART_INF_F;
  int best_j = INT_MAX;
  if (e < bm) {
#pragma unroll 4
    for (int s = way; s < splits; s += MERGE_WAYS) {
      const size_t o = static_cast<size_t>(s) * bm + e;
      const float d = part_d2[o];
      const int j = part_idx[o];
      if (before(d, j, best, best_j)) {
        best = d;
        best_j = j;
      }
    }
  }
  s_d[way][lane] = best;
  s_j[way][lane] = best_j;
  __syncthreads();
  if (way == 0 && e < bm) {
    for (int w = 1; w < MERGE_WAYS; ++w) {
      if (before(s_d[w][lane], s_j[w][lane], best, best_j)) {
        best = s_d[w][lane];
        best_j = s_j[w][lane];
      }
    }
    idx[e] = best_j;
    d2[e] = best;
  }
}

}  // namespace

// template [B, m, 3] f32, target [B, n, 3] f32, mask [B, n] bool,
// idx [B, m] int32, d2 [B, m] f32 (m, n >= 1); the targets in `splits`
// splits of `len` (splits = ceil(n / len)); part_idx / part_d2 [splits, B, m]
// scratch, unused where splits == 1.  Returns cudaGetLastError().
extern "C" int mrcc_nn_search(const float* tmpl, const float* target,
                              const uint8_t* mask, int* idx, float* d2,
                              int* part_idx, float* part_d2, int batch,
                              int m, int n, int splits, int len,
                              cudaStream_t stream) {
  if (m < 1 || n < 1 || len < 1 || splits != (n + len - 1) / len ||
      splits > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0) {
    const dim3 grid((m + TILE_M - 1) / TILE_M, splits, batch);
    if (splits == 1) {
      nn_split_kernel<<<grid, THREADS, 0, stream>>>(tmpl, target, mask, idx,
                                                    d2, batch, m, n, len);
    } else {
      nn_split_kernel<<<grid, THREADS, 0, stream>>>(
          tmpl, target, mask, part_idx, part_d2, batch, m, n, len);
      const int bm = batch * m;
      nn_merge_kernel<<<(bm + MERGE_POINTS - 1) / MERGE_POINTS,
                        MERGE_POINTS * MERGE_WAYS, 0, stream>>>(
          part_idx, part_d2, idx, d2, bm, splits);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
