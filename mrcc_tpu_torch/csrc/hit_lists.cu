// The per-offset hit lists of a gather map: the first stage of every conv
// that reads a map through lists (K3's down and up convs and their int8
// counterparts, list_mma.cuh / q8_mma.cuh; the weight-gradient kernels,
// dw_gemm.cuh).  Each map of a hierarchy is listed once, by one entry
// point a map kind below, and every conv over it reads those lists
// (mrcc_tpu_torch/ops/hit_lists.py):
//
//   for each offset k, in row order r = b * n_rows + i (b-major, then i),
//   every row whose source src(k, b, i) = j is >= 0 (a hit) gives the pair
//     fidx[k][pos] = b * n_in + j   (the gathered input row)
//     gidx[k][pos] = r              (the output / cotangent row)
//   and count[k] = the number of hits of k.
//
// The source is one of four maps: a level's k3 map by the self-keyed key
// search (SkMap) or by its neighbour tables (TableMap), which give the
// same lists; a coarse level's child map (ChildMap, the down conv's); a
// fine level's parent / octant map with row_ok folded in (ParentMap, the
// up conv's).  Misses, gated-off offsets and padding rows never enter a
// list.
//
// Positions come from a scan of the hit flags in row order: one kernel, a
// decoupled look-back.  Block t (a ticket taken in launch order, so every
// earlier tile belongs to a block that is already running) owns tile
// t % tiles of offset t / tiles: TILE rows, ITEMS per thread, striped
// so that each pass of THREADS rows is read coalesced.  It publishes its
// tile's hit count, looks back over the earlier tiles of its offset for
// their sum (one warp, 32 tiles a round, stopping at the nearest tile that
// has published its inclusive prefix), publishes its own inclusive prefix
// and scatters its hits in row order (warp ballots).  The atomic only
// hands out tiles; the lists themselves are the same bits for the same
// inputs.  The status words must be zero before the launch (build clears
// them with one memset).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather_gemm.cuh"  // find_key, k3_delta

namespace mrcc {
namespace hitlist {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;

// status word of a tile: flag in bits 62-63 (0 nothing yet, 1 the tile's
// own count, 2 the inclusive prefix of the offset up to this tile), the
// value in the low 32 bits
constexpr unsigned long long AGGREGATE = 1ull << 62;
constexpr unsigned long long INCLUSIVE = 2ull << 62;

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The hits of offset k before tile `tile`: warp-wide look-back over the
// status words st[0, tile).  Called by one whole warp; lane 0's value is
// the result.
__device__ __forceinline__ int look_back(const unsigned long long* st,
                                         int tile) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int p = tile - 1;; p -= 32) {
    const int q = p - lane;
    unsigned long long s = INCLUSIVE;  // before tile 0: an empty prefix
    if (q >= 0) {
      do {
        s = load_acquire(st + q);
      } while ((s >> 62) == 0);
    }
    const unsigned incl = __ballot_sync(0xffffffffu, (s >> 62) == 2);
    // the nearest tile with its inclusive prefix ends the sum
    const int stop = incl ? __ffs(incl) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(s & 0xffffffffu) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    excl += __shfl_sync(0xffffffffu, v, 0);
    if (incl) return excl;
  }
}

// src(k, b, i) for ITEMS rows of one thread; a source may overload this
// (found by argument-dependent lookup) to resolve its rows side by side.
template <class Source>
__device__ __forceinline__ void resolve(const Source& src, int k,
                                        const int (&b)[ITEMS],
                                        const int (&i)[ITEMS],
                                        int (&j)[ITEMS]) {
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
    j[it] = b[it] < 0 ? -1 : src(k, b[it], i[it]);
}

// grid (K * tiles), THREADS threads; tiles = ceil(B * n_rows / TILE).
// lists: fidx [K, B * n_rows] then gidx [K, B * n_rows] (int32; entries
// past count[k] are left as they were); status: K * tiles words then the
// ticket, all zero.
template <class Source>
__global__ void __launch_bounds__(THREADS)
hit_lists_kernel(Source src, int* __restrict__ lists,
                 unsigned long long* __restrict__ status,
                 int* __restrict__ count, int batch, int n_in, int n_rows,
                 int tiles) {
  __shared__ int ticket;
  __shared__ int warp_before[ITEMS][WARPS];
  __shared__ int tile_before;
  __shared__ int tile_hits;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0)
    ticket = atomicAdd(reinterpret_cast<unsigned int*>(
                           status + static_cast<size_t>(gridDim.x)), 1u);
  __syncthreads();
  const int k = ticket / tiles;
  const int tile = ticket % tiles;
  const int total = batch * n_rows;
  const int r0 = tile * TILE;

  int bs[ITEMS], is[ITEMS], j[ITEMS];
  unsigned mask[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int r = r0 + it * THREADS + threadIdx.x;
    bs[it] = r < total ? r / n_rows : -1;  // -1: past the rows
    is[it] = r < total ? r - bs[it] * n_rows : 0;
  }
  resolve(src, k, bs, is, j);
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    mask[it] = __ballot_sync(0xffffffffu, j[it] >= 0);
    if (lane == 0) warp_before[it][warp] = __popc(mask[it]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // exclusive prefix over (pass, warp), row order
    int sum = 0;
    for (int it = 0; it < ITEMS; ++it)
      for (int w = 0; w < WARPS; ++w) {
        const int c = warp_before[it][w];
        warp_before[it][w] = sum;
        sum += c;
      }
    unsigned long long* st = status + static_cast<size_t>(k) * tiles;
    store_release(st + tile,
                  (tile == 0 ? INCLUSIVE : AGGREGATE) |
                      static_cast<unsigned long long>(sum));
    tile_hits = sum;
  }
  __syncthreads();
  if (warp == 0 && tile > 0) {
    const unsigned long long* st = status + static_cast<size_t>(k) * tiles;
    const int excl = look_back(st, tile);
    if (lane == 0) {
      store_release(status + static_cast<size_t>(k) * tiles + tile,
                    INCLUSIVE | static_cast<unsigned long long>(
                                    excl + tile_hits));
      tile_before = excl;
    }
  } else if (warp == 0 && lane == 0) {
    tile_before = 0;
  }
  __syncthreads();
  const int base = tile_before;
  if (tile == tiles - 1 && threadIdx.x == 0) count[k] = base + tile_hits;
  int* fidx = lists + static_cast<size_t>(k) * total;
  int* gidx = lists + (static_cast<size_t>(gridDim.x / tiles) + k) * total;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    if (j[it] < 0) continue;
    const int r = r0 + it * THREADS + threadIdx.x;
    const int b = r / n_rows;
    const int pos = base + warp_before[it][warp] +
                    __popc(mask[it] & ((1u << lane) - 1u));
    fidx[pos] = b * n_in + j[it];
    gidx[pos] = r;
  }
}

// Clear status, then build the lists; count[k] = 0 where the map has no
// rows.  status holds K * tiles + 1 words.  Returns the first CUDA error.
template <class Source>
int build(const Source& src, int* lists, unsigned long long* status,
          int* count, int k, int batch, int n_in, int n_rows,
          cudaStream_t stream) {
  const int total = batch * n_rows;
  if (k <= 0) return 0;
  if (total <= 0)
    return static_cast<int>(
        cudaMemsetAsync(count, 0, k * sizeof(int), stream));
  const int tiles = (total + TILE - 1) / TILE;
  const size_t words = static_cast<size_t>(k) * tiles + 1;
  cudaError_t err = cudaMemsetAsync(status, 0, words * sizeof(*status), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  hit_lists_kernel<Source><<<k * tiles, THREADS, 0, stream>>>(
      src, lists, status, count, batch, n_in, n_rows, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hitlist
}  // namespace mrcc

namespace {

using namespace mrcc;

constexpr int K2 = 8;
constexpr int K3 = 27;

// A level's k3 map by the self-keyed search: key + delta_k in the item's
// sorted key row, gated by the row's offset bit (a border query can alias
// a real key across the packed fields); key / kbits [B, n].
struct SkMap {
  const int* key;
  const int* kbits;
  int n;

  __device__ __forceinline__ int operator()(int k, int b, int i) const {
    const size_t row = static_cast<size_t>(b) * n + i;
    if (!((kbits[row] >> k) & 1)) return -1;
    if (k == 13) return i;
    const int* krow = key + static_cast<size_t>(b) * n;
    return find_key(krow, n, krow[i] + k3_delta(k));
  }
};

// SkMap's rows side by side: one branchless binary search a row (lower
// bound of key + delta_k in the item's key row), all ITEMS rows of a
// thread stepping together so that their loads overlap.
__device__ __forceinline__ void resolve(const SkMap& src, int k,
                                        const int (&b)[hitlist::ITEMS],
                                        const int (&i)[hitlist::ITEMS],
                                        int (&j)[hitlist::ITEMS]) {
  constexpr int N = hitlist::ITEMS;
  const int* krow[N];
  int q[N], pos[N];
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int bb = b[it] < 0 ? 0 : b[it];
    krow[it] = src.key + static_cast<size_t>(bb) * src.n;
    q[it] = __ldg(krow[it] + i[it]) + k3_delta(k);
    pos[it] = 0;
  }
  for (int len = src.n; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int it = 0; it < N; ++it)
      pos[it] += __ldg(krow[it] + pos[it] + half - 1) < q[it] ? half : 0;
    len -= half;
  }
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const bool on = b[it] >= 0 &&
                    ((__ldg(src.kbits + static_cast<size_t>(b[it]) * src.n +
                            i[it]) >> k) & 1);
    const int lb = pos[it] + (__ldg(krow[it] + pos[it]) < q[it]);
    j[it] = !on ? -1
            : k == 13 ? i[it]
            : (lb < src.n && __ldg(krow[it] + lb) == q[it]) ? lb
                                                            : -1;
  }
}

// An index map [K, B, n] with its hit flags: a level's k3 tables
// (TableMap, 27 offsets) or a coarse level's child map (ChildMap, 8
// octants: row p of item b lists its fine child in octant k).
struct IndexMap {
  const int* idx;
  const uint8_t* hit;
  int batch;
  int n;

  __device__ __forceinline__ int operator()(int k, int b, int i) const {
    const size_t o = (static_cast<size_t>(k) * batch + b) * n + i;
    return hit[o] ? idx[o] : -1;
  }
};
struct TableMap : IndexMap {};
struct ChildMap : IndexMap {};

// A fine level's parent map: parent_idx / row_ok / octant [B, n]; row c of
// item b has parent parent_idx in octant octant where row_ok (valid &
// parent_ok: children of overflowed parents alias slot capacity - 1 and
// enter no list).
struct ParentMap {
  const int* parent_idx;
  const uint8_t* row_ok;
  const int* octant;
  int n;

  __device__ __forceinline__ int operator()(int k, int b, int c) const {
    const size_t at = static_cast<size_t>(b) * n + c;
    return (row_ok[at] && octant[at] == k) ? parent_idx[at] : -1;
  }
};

}  // namespace

// Every entry point writes lists [2, K, B * n_out] int32 (the source rows
// b * n_in + j, then the map rows b * n_out + i; entries past count[k]
// left as they were) and count [K] int32, with status [K * ceil(B * n_out
// / 2048) + 1] u64 as scratch, and returns cudaGetLastError().

// A level's k3 map (K = 27, n_in = n_out = n): key / kbits [B, n] int32.
extern "C" int mrcc_hit_lists_sk(const int* key, const int* kbits, int* lists,
                                 unsigned long long* status, int* count,
                                 int batch, int n, cudaStream_t stream) {
  return hitlist::build(SkMap{key, kbits, n}, lists, status, count, K3, batch,
                        n, n, stream);
}

// ... by its tables: nbr_idx [27, B, n] int32, nbr_hit [27, B, n] bool.
extern "C" int mrcc_hit_lists_k3map(const int* nbr_idx, const uint8_t* nbr_hit,
                                    int* lists, unsigned long long* status,
                                    int* count, int batch, int n,
                                    cudaStream_t stream) {
  return hitlist::build(TableMap{{nbr_idx, nbr_hit, batch, n}}, lists, status,
                        count, K3, batch, n, n, stream);
}

// A coarse level's child map (K = 8): child_idx / child_hit [8, B, n_out]
// into the fine level's n_in rows.
extern "C" int mrcc_hit_lists_down(const int* child_idx,
                                   const uint8_t* child_hit, int* lists,
                                   unsigned long long* status, int* count,
                                   int batch, int n_in, int n_out,
                                   cudaStream_t stream) {
  return hitlist::build(ChildMap{{child_idx, child_hit, batch, n_out}}, lists,
                        status, count, K2, batch, n_in, n_out, stream);
}

// A fine level's parent map (K = 8): parent_idx / octant [B, n_out] int32,
// row_ok [B, n_out] bool, into the coarse level's n_in rows.
extern "C" int mrcc_hit_lists_up(const int* parent_idx, const uint8_t* row_ok,
                                 const int* octant, int* lists,
                                 unsigned long long* status, int* count,
                                 int batch, int n_in, int n_out,
                                 cudaStream_t stream) {
  return hitlist::build(ParentMap{parent_idx, row_ok, octant, n_out}, lists,
                        status, count, K2, batch, n_in, n_out, stream);
}
