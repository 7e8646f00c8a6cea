// K1 — stable ascending argsort of int32 keys [B, N], any N < 2^31.
//
// Replaces: mrcc_tpu/ops/sort_pallas.py::bitonic_argsort (the [R, 128]
// roll-based bitonic network of _sort_kernel / _stage).
//
// Contract: stable under duplicate keys (voxelize sorts many points per
// voxel, every downsample many children per parent) and any number of
// KEY_PAD rows; sorted keys and the permutation, both int32.
//
// What bounds it on the card: at the main path's sizes ([8, 16384] ...
// [2, 131072]) the bytes are a few MB, under 2 us at 3.35 TB/s, so a sort
// is bounded by launches, latency and how many SMs it keeps busy.  The
// first version, a bitonic network, ran one block per row (8 blocks on 132
// SMs), did n log^2 n / 4 compare-exchanges with a barrier per stage,
// padded rows to a power of two and added a launch per global stage past
// 2^14 entries, and stopped at 2^17.
//
// Design: an LSD radix sort of (key', index) pairs, key' = key with its
// sign bit flipped so that signed order is unsigned order.  Three passes of
// 11-bit digits (bits 0-10, 11-21, 22-31); each pass is stable, so the
// sort is stable by construction and needs no tie rule and no padding.
// Each row is cut into tiles of 2048 entries (256 threads x 8), so
// [8, 12544] already runs 56 blocks.  The row histograms of all three
// digits do not depend on the order: the first pass counts them in the
// same read of the keys as its tile histograms.  Per pass, three kernels:
//   - radix_hist: each tile's histogram of the pass's digit (shared-memory
//     counts, warp-aggregated with __match_any_sync);
//   - radix_scan: each tile's first slot for each digit, the row's count of
//     smaller digits plus the digit's count in earlier tiles; 64 blocks a
//     row (32 digits each, the tiles cut into 8 chunks), so one long row
//     scans as fast as many short ones;
//   - radix_scatter: each warp ranks its entries 32 at a time in order
//     (__match_any_sync on the digit, running per-warp counts in shared
//     memory), a per-digit prefix over the 8 warps adds the warps before
//     it, and every entry goes to its slot.
// The first pass reads the int32 keys and makes the index itself; the last
// writes the sorted keys (sign restored) and the permutation.  Nine
// launches and one memset, no host synchronisation; the wrapper allocates
// every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBits = 11;
constexpr int kRadix = 1 << kBits;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 entries
constexpr int kPasses = 3;
constexpr int kScanThreads = 256;
constexpr uint32_t kNone = 0xffffffffu;   // digit of a lane past the row
constexpr size_t kScatterSmem = sizeof(int) * kWarps * kRadix;  // 64 KB

__device__ __forceinline__ uint32_t digit_of(uint32_t k, int pass) {
  return (k >> (pass * kBits)) & (kRadix - 1);
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Position in the row of item i of this thread in tile t: warp w owns the
// 256 consecutive entries from w * 256, 32 per item.
__device__ __forceinline__ int entry_pos(int t, int i) {
  return t * kTile + (threadIdx.x >> 5) * (32 * kItems) + i * 32 +
         (threadIdx.x & 31);
}

// Tile histograms of one pass's digit: cnt[b, t, :].  FIRST (pass 0):
// key is the raw int32 key row, and the row histograms of all three
// digits, which do not depend on the order, are counted too (into rowtot,
// zeroed before); else key holds key'.  grid (tiles, B).
template <bool FIRST>
__global__ void __launch_bounds__(kThreads)
radix_hist(const int* __restrict__ key, int* __restrict__ cnt,
           int* __restrict__ rowtot, int n, int tiles, int pass, int batch) {
  constexpr int P = FIRST ? kPasses : 1;
  __shared__ int h[P][kRadix];
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  for (int d = threadIdx.x; d < P * kRadix; d += kThreads)
    h[d / kRadix][d % kRadix] = 0;
  __syncthreads();
  const int* row = key + static_cast<size_t>(b) * n;
  const unsigned below = lanes_below();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pos = entry_pos(t, i);
    const bool valid = pos < n;
    uint32_t k = valid ? static_cast<uint32_t>(row[pos]) : 0u;
    if (FIRST) k ^= 0x80000000u;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint32_t d = valid ? digit_of(k, FIRST ? p : pass) : kNone;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (valid && (peers & below) == 0) atomicAdd(&h[p][d], __popc(peers));
    }
  }
  __syncthreads();
  int* c = cnt + (static_cast<size_t>(b) * tiles + t) * kRadix;
  for (int d = threadIdx.x; d < kRadix; d += kThreads) c[d] = h[0][d];
  if (FIRST) {
    for (int d = threadIdx.x; d < P * kRadix; d += kThreads) {
      const int v = h[d / kRadix][d % kRadix];
      if (v) {
        atomicAdd(rowtot + (static_cast<size_t>(d / kRadix) * batch + b) *
                               kRadix + d % kRadix,
                  v);
      }
    }
  }
}

// off[b, t, d] = sum_{d' < d} tot[b, d'] + sum_{t' < t} cnt[b, t', d],
// tot the row histogram of the pass's digit.  grid (kRadix / 32, B),
// kScanThreads threads: lane = digit of the block's 32, warp = a chunk of
// the tiles, so every row's scan runs on 64 blocks whatever its length.
__global__ void __launch_bounds__(kScanThreads)
radix_scan(const int* __restrict__ cnt, const int* __restrict__ tot,
           int* __restrict__ off, int tiles) {
  constexpr int kChunks = kScanThreads / 32;
  __shared__ int part[kChunks][32];
  __shared__ int red[kChunks];
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * 32;
  const int lane = threadIdx.x & 31;
  const int chunk = threadIdx.x >> 5;
  const int d = d0 + lane;
  const int* rt = tot + static_cast<size_t>(b) * kRadix;
  const size_t base = static_cast<size_t>(b) * tiles * kRadix;
  const int per = (tiles + kChunks - 1) / kChunks;
  const int t0 = min(tiles, chunk * per);
  const int t1 = min(tiles, t0 + per);
  int s = 0;
  for (int t = t0; t < t1; ++t) s += cnt[base + static_cast<size_t>(t) * kRadix + d];
  part[chunk][lane] = s;
  // the row's count of digits before d0
  int below = 0;
  for (int e = threadIdx.x; e < d0; e += kScanThreads) below += rt[e];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    below += __shfl_xor_sync(0xffffffffu, below, o);
  if (lane == 0) red[chunk] = below;
  __syncthreads();
  int run = 0;
#pragma unroll
  for (int w = 0; w < kChunks; ++w) run += red[w];
  // digits d0 .. d - 1 of the block
  const int mine = rt[d];
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  run += incl - mine;
  for (int w = 0; w < chunk; ++w) run += part[w][lane];
  for (int t = t0; t < t1; ++t) {
    const size_t e = base + static_cast<size_t>(t) * kRadix + d;
    off[e] = run;
    run += cnt[e];
  }
}

// One stable scatter pass.  FIRST: key_in is the raw int32 key row and the
// index is the position; else key_in holds key' and idx_in the indices.
// LAST: writes key (sign restored) and index to the outputs; else writes
// key' and index.  grid (tiles, B), kScatterSmem dynamic shared memory.
template <bool FIRST, bool LAST>
__global__ void __launch_bounds__(kThreads)
radix_scatter(const int* __restrict__ key_in, const int* __restrict__ idx_in,
              int* __restrict__ key_out, int* __restrict__ idx_out,
              const int* __restrict__ off, int n, int tiles, int pass) {
  extern __shared__ int wcnt[];  // [kWarps][kRadix]
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  {
    int4* z = reinterpret_cast<int4*>(wcnt);
    for (int e = threadIdx.x; e < kWarps * kRadix / 4; e += kThreads)
      z[e] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  const size_t rb = static_cast<size_t>(b) * n;
  const unsigned below = lanes_below();
  int* wc = wcnt + warp * kRadix;
  uint32_t k[kItems];
  int id[kItems];
  int rank[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pos = entry_pos(t, i);
    const bool valid = pos < n;
    k[i] = 0;
    id[i] = 0;
    if (valid) {
      k[i] = static_cast<uint32_t>(key_in[rb + pos]);
      if (FIRST) k[i] ^= 0x80000000u;
      id[i] = FIRST ? pos : idx_in[rb + pos];
    }
    const uint32_t d = valid ? digit_of(k[i], pass) : kNone;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int before = valid ? wc[d] : 0;
    rank[i] = before + __popc(peers & below);
    __syncwarp();
    if (valid && (peers & below) == 0) wc[d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // each warp's first slot per digit: the tile's slot plus earlier warps
  const int* o = off + (static_cast<size_t>(b) * tiles + t) * kRadix;
  for (int d = threadIdx.x; d < kRadix; d += kThreads) {
    int run = o[d];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcnt[w * kRadix + d];
      wcnt[w * kRadix + d] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool valid = entry_pos(t, i) < n;
    const int dst = valid ? wc[digit_of(k[i], pass)] + rank[i] : 0;
    if (valid) {
      key_out[rb + dst] =
          static_cast<int>(LAST ? (k[i] ^ 0x80000000u) : k[i]);
      idx_out[rb + dst] = id[i];
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// key [B, n] int32 -> skey [B, n] int32, perm [B, n] int32.  scratch: int32
// of 2 B n (the ping-pong keys and indices) + 4 B tiles 2048 (the tile
// histograms of the three passes, then one pass's tile offsets) + 3 B 2048
// (the row histograms), tiles = ceil(n / 2048).  n >= 1,
// 1 <= B <= 65535.  Returns cudaGetLastError().
extern "C" int mrcc_argsort_i32(const int* key, int* skey, int* perm,
                                int* scratch, int batch, int n,
                                cudaStream_t stream) {
  static const cudaError_t attr = [] {
    cudaError_t e = allow_smem(radix_scatter<true, false>, kScatterSmem);
    if (e == cudaSuccess)
      e = allow_smem(radix_scatter<false, false>, kScatterSmem);
    if (e == cudaSuccess)
      e = allow_smem(radix_scatter<false, true>, kScatterSmem);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const int tiles = (n + kTile - 1) / kTile;
  const size_t entries = static_cast<size_t>(batch) * n;
  const size_t stride = static_cast<size_t>(batch) * tiles * kRadix;
  const size_t rstride = static_cast<size_t>(batch) * kRadix;
  int* tkey = scratch;
  int* tidx = tkey + entries;
  int* cnt = tidx + entries;
  int* off = cnt + 3 * stride;
  int* rowtot = off + stride;
  const cudaError_t err =
      cudaMemsetAsync(rowtot, 0, sizeof(int) * kPasses * rstride, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, batch);
  const dim3 scan_grid(kRadix / 32, batch);
  // pass 0: key -> (skey, perm) as key' and index
  radix_hist<true><<<grid, kThreads, 0, stream>>>(key, cnt, rowtot, n, tiles,
                                                  0, batch);
  radix_scan<<<scan_grid, kScanThreads, 0, stream>>>(cnt, rowtot, off, tiles);
  radix_scatter<true, false><<<grid, kThreads, kScatterSmem, stream>>>(
      key, nullptr, skey, perm, off, n, tiles, 0);
  // pass 1: (skey, perm) -> (tkey, tidx)
  radix_hist<false><<<grid, kThreads, 0, stream>>>(skey, cnt + stride,
                                                   nullptr, n, tiles, 1,
                                                   batch);
  radix_scan<<<scan_grid, kScanThreads, 0, stream>>>(
      cnt + stride, rowtot + rstride, off, tiles);
  radix_scatter<false, false><<<grid, kThreads, kScatterSmem, stream>>>(
      skey, perm, tkey, tidx, off, n, tiles, 1);
  // pass 2: (tkey, tidx) -> (skey, perm), sign restored
  radix_hist<false><<<grid, kThreads, 0, stream>>>(tkey, cnt + 2 * stride,
                                                   nullptr, n, tiles, 2,
                                                   batch);
  radix_scan<<<scan_grid, kScanThreads, 0, stream>>>(
      cnt + 2 * stride, rowtot + 2 * rstride, off, tiles);
  radix_scatter<false, true><<<grid, kThreads, kScatterSmem, stream>>>(
      tkey, tidx, skey, perm, off, n, tiles, 2);
  return static_cast<int>(cudaGetLastError());
}
