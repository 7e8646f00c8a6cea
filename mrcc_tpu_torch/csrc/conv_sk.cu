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
// A tile of padding rows hits nothing and only writes zeros.

#include "gather_gemm.cuh"  // k3_delta
#include "gather_mma.cuh"

namespace {

using mrcc::tc::BM;
using mrcc::tc::K3;
using mrcc::tc::THREADS;

// First row of the sorted key row krow[lo, n) whose key is >= q.
__device__ __forceinline__ int lower_bound(const int* __restrict__ krow,
                                           int lo, int n, int q) {
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(krow + mid) < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

constexpr int kRun = 8;  // rows of one search run
constexpr int kWalk = 8;  // forward steps before a run searches again

// The row source of the self-keyed conv: key + delta_k in the item's
// sorted key row, gated by the row's offset bit.  The queries of one
// offset rise with the row, and so do their places in the key row: a
// thread takes one offset over a run of 8 rows, binary-searches the first
// query and walks forward from there for the rest (a few steps: the
// neighbours of consecutive voxels sit close together in key order), so a
// 64-row tile resolves its 27 x 64 neighbours in one round of 216 threads.
struct KeySearch {
  const int* key;
  const int* kbits;

  __device__ __forceinline__ void resolve(int b, int m0, int n,
                                          int* nbr) const {
    static_assert(K3 * (BM / kRun) <= THREADS, "one run a thread");
    const int* krow = key + static_cast<size_t>(b) * n;
    const int* brow = kbits + static_cast<size_t>(b) * n;
    if (threadIdx.x < K3 * (BM / kRun)) {
      const int k = threadIdx.x / (BM / kRun);
      const int r0 = (threadIdx.x % (BM / kRun)) * kRun;
      const int delta = mrcc::k3_delta(k);
      int p = -1;
      for (int r = r0; r < r0 + kRun; ++r) {
        const int row = m0 + r;
        int j = -1;
        if (row < n && ((__ldg(brow + row) >> k) & 1)) {
          if (k == 13) {
            j = row;
          } else {
            const int q = __ldg(krow + row) + delta;
            if (p < 0) {
              p = lower_bound(krow, 0, n, q);
            } else {
              for (int w = 0; w < kWalk && p < n && __ldg(krow + p) < q; ++w)
                ++p;
              if (p < n && __ldg(krow + p) < q) p = lower_bound(krow, p, n, q);
            }
            if (p < n && __ldg(krow + p) == q) j = p;
          }
        }
        nbr[k * BM + r] = j;
      }
    }
    __syncthreads();
  }
};

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
      feats, w, KeySearch{key, kbits}, lists, out, batch, n, cin, cout,
      stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int mrcc_conv_sk_bf16(const void* feats, const void* w,
                                 const int* key, const int* kbits, int* lists,
                                 void* out, int batch, int n, int cin,
                                 int cout, cudaStream_t stream) {
  const cudaError_t err = mrcc::tc::launch_gather_mma<__nv_bfloat16>(
      feats, w, KeySearch{key, kbits}, lists, out, batch, n, cin, cout,
      stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
