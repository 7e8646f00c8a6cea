// K1 — stable ascending argsort of int32 keys [B, N], N <= 2^17.
//
// Replaces: mrcc_tpu/ops/sort_pallas.py::bitonic_argsort (the [R, 128]
// roll-based bitonic network of _sort_kernel / _stage).
//
// Contract: stable under duplicate keys (voxelize sorts many points per
// voxel, every downsample many children per parent) and any number of
// KEY_PAD rows.  Each entry is packed as the uint64 (key' << 32) | index,
// key' = key with its sign bit flipped so that signed order is unsigned
// order.  The packed values are unique, so ANY correct sort of them is the
// stable argsort; bitonic needs no tie rule.  Rows pad to a power of two
// n2 with (KEY_PAD, index >= N), which sorts after every real entry.
//
// Bound on the card: at N = 16384 the bytes are 3 x 4 B per entry (key in,
// key and index out) — about 1.5 MB for B = 8, under a microsecond at
// 3.35 TB/s.  The work is n2 log2(n2)^2 / 4 compare-exchanges, all in
// shared memory, so the kernel is bounded by shared-memory bandwidth and
// barriers, not device memory.  Design: one block per batch row sorts up to
// 2^14 entries (128 KB dynamic shared memory) without leaving the SM;
// larger rows are cut into 2^14 chunks, sorted locally, then merged by
// global compare-exchange passes for the strides >= 2^14 and a shared
// memory pass for the strides below.  First version: right and simple
// (B blocks for N <= 2^14 leaves most SMs idle; a later PR splits rows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16384;  // entries sorted inside one block (128 KB)
constexpr int kThreads = 1024;
constexpr int kKeyPad = 1 << 30;

__device__ __forceinline__ uint64_t pack_entry(int key, int idx) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(key) ^ 0x80000000u)
          << 32) | static_cast<uint32_t>(idx);
}

__device__ __forceinline__ int entry_key(uint64_t v) {
  return static_cast<int>(static_cast<uint32_t>(v >> 32) ^ 0x80000000u);
}

// Bitonic stages j = j_top, j_top / 2, ..., 1 for one k, over a shared
// array of len entries whose first entry sits at position gbase of the
// padded row.  Ascending where (global position & k) == 0.
__device__ void merge_stages(uint64_t* s, int len, int gbase, int k,
                             int j_top) {
  for (int j = j_top; j > 0; j >>= 1) {
    for (int p = threadIdx.x; p < (len >> 1); p += blockDim.x) {
      int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
      int l = i + j;
      uint64_t a = s[i];
      uint64_t b = s[l];
      bool up = ((gbase + i) & k) == 0;
      if ((a > b) == up) {
        s[i] = b;
        s[l] = a;
      }
    }
    __syncthreads();
  }
}

// One block per (chunk, row).  k == 0: load keys and sort the chunk fully
// (k = 2 .. len).  k > 0: load the chunk from scratch and run the strides
// below len of stage k.  to_out: write sorted keys and indices, else write
// the chunk back to scratch.
__global__ void __launch_bounds__(kThreads)
sort_chunk(const int* __restrict__ key, uint64_t* __restrict__ scratch,
           int* __restrict__ skey, int* __restrict__ perm, int n, int n2,
           int len, int k, int to_out) {
  extern __shared__ uint64_t s[];
  const int b = blockIdx.y;
  const int gbase = blockIdx.x * len;
  uint64_t* row_scratch = scratch + static_cast<size_t>(b) * n2;
  if (k == 0) {
    const int* row_key = key + static_cast<size_t>(b) * n;
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      int g = gbase + i;
      s[i] = pack_entry(g < n ? row_key[g] : kKeyPad, g);
    }
    __syncthreads();
    for (int kk = 2; kk <= len; kk <<= 1) merge_stages(s, len, gbase, kk, kk >> 1);
  } else {
    for (int i = threadIdx.x; i < len; i += blockDim.x) s[i] = row_scratch[gbase + i];
    __syncthreads();
    merge_stages(s, len, gbase, k, len >> 1);
  }
  if (to_out) {
    int* row_skey = skey + static_cast<size_t>(b) * n;
    int* row_perm = perm + static_cast<size_t>(b) * n;
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      int g = gbase + i;
      if (g < n) {
        row_skey[g] = entry_key(s[i]);
        row_perm[g] = static_cast<int>(static_cast<uint32_t>(s[i]));
      }
    }
  } else {
    for (int i = threadIdx.x; i < len; i += blockDim.x) row_scratch[gbase + i] = s[i];
  }
}

// One compare-exchange stage (k, j) with j >= kChunk over scratch [B, n2].
__global__ void sort_global_stage(uint64_t* __restrict__ scratch, int batch,
                                  int n2, int k, int j) {
  const int half = n2 >> 1;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(batch) * half) return;
  const int b = static_cast<int>(t / half);
  const int p = static_cast<int>(t % half);
  const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
  const int l = i + j;
  uint64_t* row = scratch + static_cast<size_t>(b) * n2;
  uint64_t a = row[i];
  uint64_t c = row[l];
  bool up = (i & k) == 0;
  if ((a > c) == up) {
    row[i] = c;
    row[l] = a;
  }
}

}  // namespace

// key [B, n] int32 -> skey [B, n] int32, perm [B, n] int32.  n2 is the
// padded power of two (>= 2, >= n); scratch is [B, n2] uint64 when
// n2 > 16384, else may be null.  Returns cudaGetLastError().
extern "C" int mrcc_argsort_i32(const int* key, int* skey, int* perm,
                                uint64_t* scratch, int batch, int n, int n2,
                                cudaStream_t stream) {
  const int len = n2 < kChunk ? n2 : kChunk;
  const size_t smem = static_cast<size_t>(len) * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      sort_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kChunk * sizeof(uint64_t)));
  if (err != cudaSuccess) return err;
  const int threads = (len >> 1) < kThreads ? (len >> 1) : kThreads;
  const dim3 grid(n2 / len, batch);
  sort_chunk<<<grid, threads, smem, stream>>>(key, scratch, skey, perm, n,
                                              n2, len, 0, n2 == len);
  for (int k = len << 1; k <= n2; k <<= 1) {
    for (int j = k >> 1; j >= len; j >>= 1) {
      const long long pairs = static_cast<long long>(batch) * (n2 >> 1);
      const int blocks = static_cast<int>((pairs + 255) / 256);
      sort_global_stage<<<blocks, 256, 0, stream>>>(scratch, batch, n2, k, j);
    }
    sort_chunk<<<grid, threads, smem, stream>>>(key, scratch, skey, perm, n,
                                                n2, len, k, k == n2);
  }
  return static_cast<int>(cudaGetLastError());
}
