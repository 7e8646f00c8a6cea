// A level's k3 order: the schedule of the k3 convs' ordered tile
// (gather_mma.cuh, gather_mma_ordered_kernel), built once per level and
// read by every k3 conv on it, forward and data cotangent (the cotangent
// is the same map with W[26 - k]^T: the same hits).
//
// Why: the one-pass tile takes 64 consecutive rows in key order and runs a
// ring stage per (offset some of its rows hit, 32-channel chunk).  A row
// hits ~6-14 of the 27 offsets, but 64 neighbouring rows together hit
// nearly all, so a tile runs 2-4x the stages its rows' hits need.  Rows
// grouped by their hit mask share their offsets; grouping by the whole
// 27-bit mask leaves ~1.5-2x, by the 9-bit masks of three offset segments
// ~1.1-1.4x.
//
// Three stages, no host synchronisation:
//   - order_rows (grid (tiles, B)): the row source of the level (the key
//     search of the self-keyed conv, or its neighbour tables) resolves
//     each 64-row tile's 27 x 64 neighbours once, in row order; written as
//     nbr_rows [B, n, 27] (-1 a miss), the hit mask [B, n] (bit k: offset k
//     hits) and, where the order sorts, the sort keys [S, B, n] of the S
//     segments of 27 / S offsets: the row's sub-mask in the segment, 0 for
//     a row with no hit at all in segment 0 (it is stored as zeros there),
//     else 1 << (27 / S) (the row takes no part in the segment; it sorts
//     last);
//   - K1 (sort.cu) sorts the keys of each (segment, item) stably, so rows
//     of one sub-mask stay in key order and so spatially close;
//   - order_lists (grid (tiles, B, S)): each 64-row tile of a segment's
//     order gets its list (gather_mma.cuh, order_list_ints): the rows with
//     ROW_LOAD (an earlier segment hits the row) and ROW_FINAL (no later
//     one does), their neighbours in the segment's offsets, the offsets
//     some row hits with their 16-row group masks, and the number of rows;
//     and each (segment, item) the count of its tiles that hold rows,
//     which come first (the last such tile, or tile 0 of an empty one,
//     writes it).
// Without a sort (the one-segment identity order) tile t holds rows 64t ..
// 64t + 63, every row of the level: the one-pass tile's own schedule.

#include "gather_mma.cuh"
#include "k3_sources.cuh"

namespace {

using namespace mrcc;
using tc::BM;
using tc::K3;
using tc::THREADS;

// The order's names for the two row sources.
struct OrderKeys : tc::KeySearch {};
struct OrderTable : tc::NbrTable {};

template <class Source>
__global__ void __launch_bounds__(THREADS)
order_rows(Source source, int* __restrict__ nbr_rows, int* __restrict__ mask,
           int* __restrict__ keys, int n, int batch, int segments) {
  __shared__ int nbr[K3 * BM];
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * BM;
  source.resolve(b, m0, n, nbr);  // ends with a barrier
  for (int e = threadIdx.x; e < K3 * BM; e += THREADS) {
    const int r = e / K3;
    if (m0 + r < n)
      nbr_rows[(static_cast<size_t>(b) * n + m0 + r) * K3 + e % K3] =
          nbr[(e % K3) * BM + r];
  }
  const int r = threadIdx.x;
  if (r < BM && m0 + r < n) {
    int m = 0;
    for (int k = 0; k < K3; ++k)
      if (nbr[k * BM + r] >= 0) m |= 1 << k;
    mask[static_cast<size_t>(b) * n + m0 + r] = m;
    if (keys != nullptr) {
      const int ks = K3 / segments;
      for (int s = 0; s < segments; ++s) {
        const int sub = (m >> (s * ks)) & ((1 << ks) - 1);
        keys[(static_cast<size_t>(s) * batch + b) * n + m0 + r] =
            sub != 0 ? sub : (s == 0 && m == 0 ? 0 : 1 << ks);
      }
    }
  }
}

// perm / skey: K1's [S * B, n] permutation and sorted keys, or null for
// the identity order (S = 1).  grid (tiles, B, S).
__global__ void __launch_bounds__(THREADS)
order_lists(const int* __restrict__ nbr_rows, const int* __restrict__ mask,
            const int* __restrict__ skey, const int* __restrict__ perm,
            int* __restrict__ lists, int* __restrict__ counts, int n,
            int batch) {
  const int segments = gridDim.z;
  const int ks = K3 / segments;
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int g = s * batch + b;
  __shared__ int rows[BM];
  __shared__ int any[K3];
  __shared__ int live;
  int* list = lists + (static_cast<size_t>(g) * gridDim.x + t) *
                          tc::order_list_ints(ks);
  if (threadIdx.x < K3) any[threadIdx.x] = 0;
  if (threadIdx.x == 0) live = 0;
  __syncthreads();
  if (threadIdx.x < BM) {
    const int pos = t * BM + threadIdx.x;
    int e = -1;
    if (pos < n) {
      const size_t o = static_cast<size_t>(g) * n + pos;
      const int row = perm == nullptr          ? pos
                      : skey[o] != (1 << ks) ? perm[o]
                                               : -1;
      if (row >= 0) {
        const int m = mask[static_cast<size_t>(b) * n + row];
        e = row;
        if (m & ((1 << (s * ks)) - 1)) e |= tc::ROW_LOAD;
        if ((m >> ((s + 1) * ks)) == 0) e |= tc::ROW_FINAL;
        atomicAdd(&live, 1);
      }
    }
    rows[threadIdx.x] = e;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ks * BM; e += THREADS) {
    const int j = e / BM;
    const int r = e % BM;
    int v = -1;
    if (rows[r] >= 0)
      v = nbr_rows[(static_cast<size_t>(b) * n + (rows[r] & tc::ROW_INDEX)) *
                       K3 +
                   s * ks + j];
    list[e] = v;
    if (v >= 0) atomicOr(any + j, 1 << (r / 16));
  }
  if (threadIdx.x < BM) list[ks * BM + threadIdx.x] = rows[threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) {
    int* klist = list + ks * BM + BM;
    int c = 0;
    for (int j = 0; j < ks; ++j)
      if (any[j]) klist[c++] = j | (any[j] << 8);
    for (int j = c; j < ks; ++j) klist[j] = 0;
    klist[ks] = c;
    klist[ks + 1] = live;
    const int next = (t + 1) * BM;  // has the next tile rows?
    const bool more =
        next < n && (perm == nullptr ||
                     skey[static_cast<size_t>(g) * n + next] != (1 << ks));
    if (live > 0 && !more) counts[g] = t + 1;
    if (t == 0 && live == 0) counts[g] = 0;
  }
}

template <class Source>
int rows_launch(const Source& source, int* nbr_rows, int* mask, int* keys,
                int batch, int n, int segments, cudaStream_t stream) {
  if (n <= 0 || batch <= 0) return 0;
  if (segments < 1 || K3 % segments != 0 || n > tc::ROW_INDEX)
    return static_cast<int>(cudaErrorInvalidValue);
  order_rows<<<dim3((n + BM - 1) / BM, batch), THREADS, 0, stream>>>(
      source, nbr_rows, mask, keys, n, batch, segments);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Stage 1 over the level's sorted keys and bitmap (key / kbits [B, n]
// int32) or its neighbour tables (nbr_idx [27, B, n] int32, nbr_hit [27, B,
// n] bool): nbr_rows [B, n, 27] int32, mask [B, n] int32, keys [S, B, n]
// int32 (null: no sort keys).  Each returns cudaGetLastError().
extern "C" int mrcc_k3_order_rows_keys(const int* key, const int* kbits,
                                       int* nbr_rows, int* mask, int* keys,
                                       int batch, int n, int segments,
                                       cudaStream_t stream) {
  return rows_launch(OrderKeys{{key, kbits}}, nbr_rows, mask, keys, batch, n,
                     segments, stream);
}

extern "C" int mrcc_k3_order_rows_table(const int* nbr_idx,
                                        const uint8_t* nbr_hit, int* nbr_rows,
                                        int* mask, int* keys, int batch,
                                        int n, int segments,
                                        cudaStream_t stream) {
  return rows_launch(OrderTable{{nbr_idx, nbr_hit, batch}}, nbr_rows, mask,
                     keys, batch, n, segments, stream);
}

// Stage 3: lists [S, B, ceil(n / 64), order_list_ints(27 / S)] and counts
// [S, B] int32 from stage 1's nbr_rows and mask and K1's skey / perm [S *
// B, n] (both null: the identity order, S = 1).  Returns
// cudaGetLastError().
extern "C" int mrcc_k3_order_lists(const int* nbr_rows, const int* mask,
                                   const int* skey, const int* perm,
                                   int* lists, int* counts, int batch, int n,
                                   int segments, cudaStream_t stream) {
  if (n <= 0 || batch <= 0) return 0;
  if (segments < 1 || K3 % segments != 0 || (perm == nullptr) !=
      (skey == nullptr) || (perm == nullptr && segments != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  order_lists<<<dim3((n + BM - 1) / BM, batch, segments), THREADS, 0,
                stream>>>(nbr_rows, mask, skey, perm, lists, counts, n,
                          batch);
  return static_cast<int>(cudaGetLastError());
}
