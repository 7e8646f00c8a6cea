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
// clamped rank of its query, whether or not the query is valid.  q is the
// int32 sum with wrap-around, as the plain twin adds.
//
// Bound on the card: bytes.  It reads keys, qbase and qbits once and writes
// K * B * Nq indices (4 bytes) and hits (1 byte): 19.6 MB at 2 x 72448 rows
// and 27 offsets, 6.4 us at 3.35 TB/s (a kernel that only writes those
// outputs takes about that).  The first version, one thread per row
// binary-searching the whole key row in L2 for each searched offset, ran
// 4-5 times the bound.
//
// Design.  Offsets are processed in ascending delta order, in groups: a
// group is a run of deltas that each exceed the previous one by 1 (the
// z-triples of K3_OFFSETS, rank_plan's chain).  Inside a group only the
// first delta is searched; each next rank follows from the previous one,
// rank(q + 1) = rank(q) + #{keys == q}: one compare for unique keys, a
// second search only where q repeats (at KEY_PAD).  So a k=3 table costs 9
// searches a row, not 27.
//
// A block takes T consecutive query rows of one item (blockDim.x = T).
// The caller's query bases are ascending for the level's own tables, so a
// block's ranks for a group lie in one narrow window of the keys: with
// [qlo, qhi] the bases of a set of rows and d0 / d1 the group's first and
// last delta, every rank the set needs lies in
// [lo, hi] = [lower_bound(qlo + d0), lower_bound(qhi + d1)], and every key
// it reads in [lo, min(hi, N - 1)].  A kernel's time is its slowest
// block's, and at a sorted level the block where the real rows end and the
// KEY_PAD rows begin would get one window over every key from its last real
// rows up.  So each block keeps two windows a group: one for its rows under
// its largest base and one for the rows at it (the padding run; one row
// elsewhere).  The block
//   - loads a sample of the key row (every stride-th key, at most 1024)
//     with its bases, all in flight together;
//   - finds the 4 G window ends once: each end's stride in the sample (in
//     shared memory), then a segment of 6 lanes searches that stride with
//     6 pivots a step (3 dependent loads for 256 keys);
//   - lays the windows of at most W keys side by side in shared memory, in
//     order, while their sum stays within W keys, and stages them with
//     asynchronous 4-byte copies (cp.async, all in flight) and one barrier.
// Then each thread runs its row's groups with no barrier: a staged window
// is searched in shared memory (8 steps at the ~230-key windows of the
// production levels); a window that did not fit (unsorted query bases, a
// jump across empty space, a padding run) is searched in global memory
// inside [lo, hi], its end keys first, so a query past either end (the
// padding rows') costs no search.  Where some row's q can wrap around int32
// the window is the whole row and the chain restarts after q = INT_MAX.
// Stores are coalesced in the [K, B, Nq] layout.  T and W are the
// wrapper's (ops/rank.py RANK_ROWS, RANK_WINDOW), so its CPU emulation runs
// the same windows.
//
// What the card shows (textual variants of this file timed in turns on
// an H100: the setup alone, without staging, ...): at 2 x 72448 the block
// setup takes ~40 % of the time (staging alone ~16 %; searching the windows
// in global memory instead costs more), and the rows' searches and tests
// (~9 x 8 shared-memory steps, 27 chained tests and 54 stores a row) most
// of the rest.

#include <climits>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 32;
constexpr int MAX_T = 512;
constexpr int MAX_W = 10240;  // staged keys: 40 KB (under the 48 KB default)
constexpr int SEG = 6;        // lanes a window search
constexpr int SEGS_PER_WARP = 5;
constexpr int SAMPLE_STRIDE = 256;  // keys between samples, at least
constexpr int MAX_SAMPLES = 1024;

// The key row in global memory (L2).
struct GlobalKeys {
  static constexpr bool kEnds = true;  // test the end keys before a search
  const int* __restrict__ row;
  __device__ __forceinline__ int operator[](int j) const {
    return __ldg(row + j);
  }
};

// keys[lo, lo + len) staged in shared memory at buf.
struct SharedKeys {
  static constexpr bool kEnds = false;
  const int* buf;
  int lo;
  __device__ __forceinline__ int operator[](int j) const {
    return buf[j - lo];
  }
};

// First position in [lo, hi) whose key is >= q (hi if none).  In global
// memory the end keys first: a query past either end of the range needs no
// search (both loads in flight together).
template <class Keys>
__device__ __forceinline__ int lower_bound(const Keys& keys, int lo, int hi,
                                           int q) {
  if (Keys::kEnds && lo < hi) {
    const int first = keys[lo], last = keys[hi - 1];
    if (first >= q) return lo;
    if (last < q) return hi;
    ++lo;  // the answer is in [lo + 1, hi - 1]
    --hi;
  }
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// One group of chained offsets for one row: plan positions [j0, j1), every
// rank inside [lo, hi].
template <class Keys>
__device__ __forceinline__ void rank_group(
    const Keys& keys, int lo, int hi, int n, int j0, int j1, int qb, int bits,
    bool live, const int* s_off, const int* s_delta, int* __restrict__ idx,
    uint8_t* __restrict__ hit, size_t plane, size_t row) {
  int r = lo;
  int q_prev = 0;
  bool eq_prev = false;
  for (int j = j0; j < j1; ++j) {
    const int q = wrap_add(qb, s_delta[j]);
    if (j == j0 || q_prev == INT_MAX) {
      r = lower_bound(keys, lo, hi, q);
    } else if (eq_prev) {
      // q == q_prev + 1: rank(q) = #{keys <= q_prev}
      r += 1;
      if (r < n && keys[r] == q_prev) r = lower_bound(keys, r, hi, q);
    }
    const bool eq = r < n && keys[r] == q;
    if (live) {
      const int kk = s_off[j];
      const size_t o = kk * plane + row;
      idx[o] = min(r, n - 1);
      hit[o] = (eq && ((bits >> kk) & 1)) ? 1 : 0;
    }
    q_prev = q;
    eq_prev = eq;
  }
}

// plan: [3, k] int32 in processing order (ascending delta): the offset
// index, its delta, and 1 where the delta is the previous one plus 1.
__global__ void __launch_bounds__(MAX_T)
rank_kernel(const int* __restrict__ keys, const int* __restrict__ qbase,
            const int* __restrict__ qbits, const int* __restrict__ plan,
            int* __restrict__ idx, uint8_t* __restrict__ hit, int batch,
            int n, int nq, int k, int w) {
  extern __shared__ int s_keys[];  // the staged windows, w keys at most
  __shared__ int s_off[MAX_K], s_delta[MAX_K];
  __shared__ int s_start[MAX_K + 1];  // group g: plan positions
                                      // [s_start[g], s_start[g + 1])
  // window 2 g + 1: group g's rows at the block's largest base, 2 g: the
  // others; base -1: searched in global memory
  __shared__ int s_lo[2 * MAX_K], s_hi[2 * MAX_K];
  __shared__ int s_base[2 * MAX_K], s_len[2 * MAX_K];
  __shared__ int s_min[MAX_T / 32], s_max[MAX_T / 32], s_below[MAX_T / 32];
  __shared__ int s_sample[MAX_SAMPLES];  // keys[e * stride]
  __shared__ int s_groups, s_total;

  const int t = threadIdx.x;
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + t;
  const bool live = i < nq;
  const int* krow = keys + static_cast<size_t>(b) * n;
  // a thread past the last row takes the last row: it is in this block, so
  // the block's minimum and maximum stay those of its rows
  const size_t row = static_cast<size_t>(b) * nq + min(i, nq - 1);
  // a sample of the key row, for the window searches: in flight with the
  // bases' loads
  const int stride =
      max(SAMPLE_STRIDE, (n + MAX_SAMPLES - 1) / MAX_SAMPLES);
  const int samples = (n + stride - 1) / stride;
  for (int e = t; e < samples; e += blockDim.x)
    __pipeline_memcpy_async(s_sample + e, krow + e * stride, sizeof(int));
  __pipeline_commit();
  const int qb = __ldg(qbase + row);
  const int bits = __ldg(qbits + row);

  if (t < 32) {  // warp 0: the plan and its groups (k <= 32)
    const bool in = t < k;
    const bool starts = in && (t == 0 || !plan[2 * k + t]);
    if (in) {
      s_off[t] = plan[t];
      s_delta[t] = plan[k + t];
    }
    const unsigned mask = __ballot_sync(0xffffffffu, starts);
    if (starts) s_start[__popc(mask & ((1u << t) - 1))] = t;
    if (t == 0) {
      s_start[__popc(mask)] = k;
      s_groups = __popc(mask);
    }
  }
  const int min_w = __reduce_min_sync(0xffffffffu, qb);
  const int max_w = __reduce_max_sync(0xffffffffu, qb);
  if ((t & 31) == 0) {
    s_min[t >> 5] = min_w;
    s_max[t >> 5] = max_w;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  int qmin = s_min[0], qmax = s_max[0];
  for (int e = 1; e < warps; ++e) {
    qmin = min(qmin, s_min[e]);
    qmax = max(qmax, s_max[e]);
  }
  const bool at_max = qb == qmax;
  const int below_w = __reduce_max_sync(0xffffffffu, at_max ? INT_MIN : qb);
  if ((t & 31) == 0) s_below[t >> 5] = below_w;
  const bool any_below = __syncthreads_or(!at_max);

  const int groups = s_groups;
  // the window ends: 4 G searches over the whole key row; each first finds
  // its stride in the sample, then a segment of SEG lanes searches that
  // stride (a (SEG + 1)-ary search: 3 dependent loads for 256 keys,
  // against 17 for one thread's binary search of 72448)
  const int lane = t & 31;
  const int part = lane % SEG;
  const int segs = warps * SEGS_PER_WARP;
  for (int round = 0; round * segs < 4 * groups; ++round) {
    const int u = round * segs + (t >> 5) * SEGS_PER_WARP + lane / SEG;
    const bool act = lane < SEG * SEGS_PER_WARP && u < 4 * groups;
    int lo = 0, hi = 0, q = 0;  // lo == hi: nothing to search
    if (act) {
      const int win = u >> 1, g = win >> 1;
      int top = qmax;  // the set's largest base
      if (!(win & 1)) {
        top = s_below[0];
        for (int e = 1; e < warps; ++e) top = max(top, s_below[e]);
      }
      const long long q_lo =
          static_cast<long long>((win & 1) ? qmax : qmin)
          + s_delta[s_start[g]];
      const long long q_hi =
          static_cast<long long>(top) + s_delta[s_start[g + 1] - 1];
      if (!(win & 1) && !any_below)
        lo = hi = n;  // no rows under the largest base: an empty window
      else if (q_lo < INT_MIN || q_hi > INT_MAX)
        lo = hi = (u & 1) ? n : 0;
      else {
        q = static_cast<int>((u & 1) ? q_hi : q_lo);
        int a = 0, z = samples;  // a: the samples under q
        while (a < z) {
          const int m = (a + z) >> 1;
          if (s_sample[m] < q) a = m + 1; else z = m;
        }
        lo = a ? (a - 1) * stride + 1 : 0;
        hi = a < samples ? a * stride : n;
      }
    }
    // pivots lo + (r + 1) len / (SEG + 1), r < SEG: nondecreasing, so the
    // lanes whose key is < q are a prefix of the segment, of c lanes
    while (__any_sync(0xffffffffu, lo < hi)) {
      const int len = hi - lo;
      const auto pivot = [&](int r) {  // len < stride <= 2^21: no overflow
        return lo + (r + 1) * len / (SEG + 1);
      };
      const bool less = lo < hi && __ldg(krow + pivot(part)) < q;
      const int c = __popc((__ballot_sync(0xffffffffu, less) >>
                            (lane - part)) & ((1u << SEG) - 1));
      if (lo < hi) {
        const int nlo = c ? pivot(c - 1) + 1 : lo;
        hi = c < SEG ? pivot(c) : hi;
        lo = nlo;
      }
    }
    if (act && part == 0) ((u & 1) ? s_hi : s_lo)[u >> 1] = lo;
  }
  __syncthreads();

  if (t < 32) {  // warp 0, lane g: which of group g's windows are staged
    const bool in = t < groups;
    int len[2] = {0, 0}, take[2] = {0, 0};
    if (in) {
      for (int v = 0; v < 2; ++v) {
        len[v] = min(s_hi[2 * t + v], n - 1) - s_lo[2 * t + v] + 1;
        take[v] = len[v] <= w ? len[v] : 0;
      }
    }
    int end = take[0] + take[1];  // inclusive prefix sum over the lanes
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, end, o);
      if (t >= o) end += u;
    }
    int at = end - take[0] - take[1], staged_end = 0;
    if (in) {
      for (int v = 0; v < 2; ++v) {
        const bool staged = len[v] <= w && at + take[v] <= w;
        s_len[2 * t + v] = len[v];
        s_base[2 * t + v] = staged ? at : -1;
        at += take[v];
        if (staged) staged_end = at;
      }
    }
    const int total = __reduce_max_sync(0xffffffffu, staged_end);
    if (t == 0) s_total = total;
  }
  __syncthreads();

  // stage: element e of the staged span belongs to the window that covers
  // it; one asynchronous copy an element, all in flight together
  const int total = s_total;
  for (int e = t, v = 0; e < total; e += blockDim.x) {
    while (s_base[v] < 0 || e >= s_base[v] + s_len[v]) ++v;
    __pipeline_memcpy_async(s_keys + e, krow + s_lo[v] + (e - s_base[v]),
                            sizeof(int));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const size_t plane = static_cast<size_t>(batch) * nq;
  const size_t out_row = static_cast<size_t>(b) * nq + i;
  for (int g = 0; g < groups; ++g) {
    const int v = 2 * g + at_max;
    const int lo = s_lo[v], hi = s_hi[v], base = s_base[v];
    if (base >= 0)
      rank_group(SharedKeys{s_keys + base, lo}, lo, hi, n, s_start[g],
                 s_start[g + 1], qb, bits, live, s_off, s_delta, idx, hit,
                 plane, out_row);
    else
      rank_group(GlobalKeys{krow}, lo, hi, n, s_start[g], s_start[g + 1],
                 qb, bits, live, s_off, s_delta, idx, hit, plane, out_row);
  }
}

}  // namespace

// keys [B, n] int32 sorted per item, qbase/qbits [B, nq] int32, plan [3, k]
// int32 on the device (k <= 32), idx [k, B, nq] int32, hit [k, B, nq] bool;
// rows: query rows a block (a multiple of 32, <= 512), window: the keys a
// block stages in shared memory, all its groups' windows together
// (<= 10240).  Returns cudaGetLastError().
extern "C" int mrcc_rank_lookup(const int* keys, const int* qbase,
                                const int* qbits, const int* plan, int* idx,
                                uint8_t* hit, int batch, int n, int nq, int k,
                                int rows, int window, cudaStream_t stream) {
  if (k < 1 || k > MAX_K || n < 1 || rows < 32 || rows > MAX_T ||
      rows % 32 != 0 || window < 1 || window > MAX_W)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0 && nq > 0) {
    const dim3 grid((nq + rows - 1) / rows, batch);
    rank_kernel<<<grid, rows, window * sizeof(int), stream>>>(
        keys, qbase, qbits, plan, idx, hit, batch, n, nq, k, window);
  }
  return static_cast<int>(cudaGetLastError());
}
