// B8 — rank lookup: neighbour tables from sorted keys, no sorts.
//
// Replaces: mrcc_tpu/ops/rank_pallas.py::_rank_call (with its wrapper
// rank_lookup, as neighbor_tables calls it).
//
//   for each offset k, item b and query row i, with q = qbase[b, i] + delta_k:
//     idx[k, b, i] = min(#{j : keys[b, j] < q}, N - 1)
//     hit[k, b, i] = bit_k(qbits[b, i]) && q in keys[b, :]
//
// keys [B, N] ascending per item (KEY_PAD padding, which may repeat);
// qbits the per-row validity bitmap (bit k: offset k's query is inside the
// coordinate window and the row is valid; K <= 32).  A miss's idx is the
// clamped rank of its query, whether or not the query is valid.
//
// The TPU kernel counts ranks as [T, W] compares over key windows that a
// boundary searchsorted places, because VMEM lane slices are its unit of
// work.  The card needs none of that: one thread per (item, query row)
// binary-searches the item's sorted keys, which stay in L2 (290 KB at 72448
// rows).  Offsets are processed in ascending delta order, and where a delta
// is the previous one plus 1 (the z-triples of K3_OFFSETS) the rank follows
// without a search: rank(q + 1) = rank(q) + #{keys == q}, which is one
// compare for unique keys (a second search only where q repeats, i.e. at
// KEY_PAD).  So a k=3 table costs 9 searches a row, not 27.
//
// Bound on the card: bytes.  It reads keys, qbase and qbits once and writes
// K * B * Nq indices (4 bytes) and hits (1 byte); the searches' L2 reads
// and ~10 integer operations per search step are far below either roofline.
// First version: no shared-memory staging of the key row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 32;

// First position in krow[lo, n) whose key is >= q (n if none).
__device__ __forceinline__ int lower_bound(const int* __restrict__ krow,
                                           int lo, int n, int q) {
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(krow + mid) < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// plan: [3, k] int32 in processing order (ascending delta): the offset
// index, its delta, and 1 where the delta is the previous one plus 1.
__global__ void __launch_bounds__(THREADS)
rank_kernel(const int* __restrict__ keys, const int* __restrict__ qbase,
            const int* __restrict__ qbits, const int* __restrict__ plan,
            int* __restrict__ idx, uint8_t* __restrict__ hit, int batch,
            int n, int nq, int k) {
  __shared__ int s_off[MAX_K];
  __shared__ int s_delta[MAX_K];
  __shared__ int s_chain[MAX_K];
  if (threadIdx.x < k) {
    s_off[threadIdx.x] = plan[threadIdx.x];
    s_delta[threadIdx.x] = plan[k + threadIdx.x];
    s_chain[threadIdx.x] = plan[2 * k + threadIdx.x];
  }
  __syncthreads();

  const int b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= nq) return;
  const int* krow = keys + static_cast<size_t>(b) * n;
  const size_t row = static_cast<size_t>(b) * nq + i;
  const int qb = __ldg(qbase + row);
  const int bits = __ldg(qbits + row);

  int r = 0;
  int q_prev = 0;
  bool eq_prev = false;
  for (int j = 0; j < k; ++j) {
    const int q = qb + s_delta[j];
    if (!s_chain[j]) {
      r = lower_bound(krow, 0, n, q);
    } else if (eq_prev) {
      // q == q_prev + 1: rank(q) = #{keys <= q_prev}
      r += 1;
      if (r < n && __ldg(krow + r) == q_prev) r = lower_bound(krow, r, n, q);
    }
    const bool eq = r < n && __ldg(krow + r) == q;
    const int kk = s_off[j];
    const size_t o = (static_cast<size_t>(kk) * batch + b) * nq + i;
    idx[o] = min(r, n - 1);
    hit[o] = (eq && ((bits >> kk) & 1)) ? 1 : 0;
    q_prev = q;
    eq_prev = eq;
  }
}

}  // namespace

// keys [B, n] int32 sorted per item, qbase/qbits [B, nq] int32, plan [3, k]
// int32 on the device (k <= 32), idx [k, B, nq] int32, hit [k, B, nq] bool.
// Returns cudaGetLastError().
extern "C" int mrcc_rank_lookup(const int* keys, const int* qbase,
                                const int* qbits, const int* plan, int* idx,
                                uint8_t* hit, int batch, int n, int nq, int k,
                                cudaStream_t stream) {
  if (k < 1 || k > MAX_K || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0 && nq > 0) {
    const dim3 grid((nq + THREADS - 1) / THREADS, batch);
    rank_kernel<<<grid, THREADS, 0, stream>>>(keys, qbase, qbits, plan, idx,
                                              hit, batch, n, nq, k);
  }
  return static_cast<int>(cudaGetLastError());
}
