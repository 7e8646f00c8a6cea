// Masked batch norm with the ReLU and residual add that follow it, forward
// and backward (ops/norm.py, sparse/nn.py SparseBatchNorm).
//
// Replaces no TPU kernel: the JAX package's norm (mrcc_tpu/sparse/nn.py
// SparseBatchNorm) is plain jnp, which XLA fuses with the ReLU and the add
// around it.  Eager PyTorch ran the same expression as ~30 ATen kernels a
// norm forward and as many backward, each a pass over the activations.
//
//   forward, rows r of x [R, C] (R = B * N), valid[r] the row mask:
//     train: n = max(#valid, 1), mean = sum_valid x / n,
//            var = sum_valid (x - mean)^2 / n (two passes, not E[x^2] -
//            mean^2); running stats += momentum * (mean, var * n /
//            max(n - 1, 1) - running)
//     eval:  mean, var = the running statistics
//     y = valid ? T(((x - mean) * rsqrt(var + eps)) * w + b) : 0
//     y = T(y + residual) (if given); y = relu(y) (if asked)
//   backward, g = dy * [y > 0] (relu) or dy, x^ = (x - mean) * rstd:
//     dbeta = sum_valid g, dgamma = sum_valid g * x^
//     dx = valid ? w * rstd * (g - dbeta / n - x^ * dgamma / n) : 0 (train)
//          valid ? w * rstd * g : 0 (eval)
//     dresidual = g on every row
// with f32 math, T the feature dtype (f32 or bf16).
//
// Bound on the card: bytes.  A norm reads x three times forward (two
// statistics passes, the apply) and writes y once; backward reads dy, x
// and y twice (the sums, dx) and writes dx (and the residual's gradient).
// The design keeps every intermediate of the eager expression (the masked
// copies, the squared deviations, x^, the ReLU mask) in registers, so a
// norm costs those passes and nothing else.
//
// Layout (chosen on the host from C alone, ops/norm.py norm_layout): each
// thread holds V channels, one 16-byte load (V = 4 in f32, 8 in bf16, less
// where C does not divide); a block is tx threads along the channels of a
// chunk (at most 32 groups of V) by ty rows (a power of two), at most 256
// threads; grid.y is the channel chunks, grid.x the row blocks.  A warp
// reads whole row segments, so loads coalesce at any C from 3 to 1024.
//
// Reductions (norm_reduce_kernel: the two statistics passes and the
// backward's sums): each row block sums its rows, reduces over ty in
// shared memory by a fixed tree and writes one partial a channel; the last
// block of a chunk to finish (an integer ticket) sums the partials in
// fixed order and writes the chunk's totals.  No float atomics, no host
// sync: the same bits for the same inputs, and the count stays on the
// card.  Between the passes the host all-reduces the totals in a
// data-parallel step (parallel/mesh.py).  The apply kernel derives each
// channel's mean and rstd from the totals itself; its first row block also
// writes them for the backward and moves the running statistics.
//
// Launches: train forward 3 (+ one memset of the tickets), eval forward
// 1, backward 2 (+ one memset).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mrcc {
namespace bn {

constexpr int kThreads = 256;  // threads a block at most

// ---------------------------------------------------------- loads, stores

__device__ __forceinline__ void unpack2(uint32_t w, float& a, float& b) {
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    static_assert(V == 1, "f32: V in 1, 2, 4");
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    unpack2(q.x, v[0], v[1]), unpack2(q.y, v[2], v[3]);
    unpack2(q.z, v[4], v[5]), unpack2(q.w, v[6], v[7]);
  } else if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    unpack2(q.x, v[0], v[1]), unpack2(q.y, v[2], v[3]);
  } else if constexpr (V == 2) {
    unpack2(*reinterpret_cast<const uint32_t*>(p), v[0], v[1]);
  } else {
    static_assert(V == 1, "bf16: V in 1, 2, 4, 8");
    v[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
        pack2(v[6], v[7]));
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint32_t*>(p) = pack2(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// x rounded to T and back (the eager expression's casts to the feature
// dtype).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

// x^ = (x - mean) * rstd, rounded as the eager expression rounds it.
__device__ __forceinline__ float normalised(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}

// ------------------------------------------------------------ reductions

// Sum acc over the block's ty rows by a fixed tree (ty a power of two);
// thread (tx, 0) ends with its channels' block sums.  red holds
// Q * kThreads * V floats.  Every thread of the block calls it.
template <int Q, int V>
__device__ __forceinline__ void block_sum(float (&acc)[Q][V], float* red) {
  const int nx = blockDim.x, tx = threadIdx.x, ty = threadIdx.y;
  const int stride = nx * blockDim.y * V;
  const int slot = (ty * nx + tx) * V;
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int i = 0; i < V; ++i) red[q * stride + slot + i] = acc[q][i];
  __syncthreads();
  for (int s = blockDim.y >> 1; s > 0; s >>= 1) {
    if (ty < s) {
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int i = 0; i < V; ++i)
          red[q * stride + slot + i] += red[q * stride + slot + s * nx * V + i];
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[q][i] = red[q * stride + tx * V + i];
}

// The same for one int a row of threads (lane tx = 0's).
__device__ __forceinline__ int block_count(int n, int* red) {
  const int ty = threadIdx.y;
  if (threadIdx.x == 0) red[ty] = n;
  __syncthreads();
  for (int s = blockDim.y >> 1; s > 0; s >>= 1) {
    if (threadIdx.x == 0 && ty < s) red[ty] += red[ty + s];
    __syncthreads();
  }
  return red[0];
}

// The quantities the reductions sum over the valid rows.  Each gives
// kQ values a channel; prepare() reads a thread's per-channel constants,
// row() loads row r's channels c0.. and returns the row's terms.

template <typename T, int V>
struct MeanSum {  // pass 1: sum x (and the count of valid rows)
  static constexpr int kQ = 1;
  static constexpr bool kCount = true;
  const T* x;
  struct Ctx {};
  __device__ Ctx prepare(int, int) const { return {}; }
  __device__ void row(const Ctx&, long long r, int c0, int c,
                      float (&t)[kQ][V]) const {
    load_vec<V>(x + r * c + c0, t[0]);
  }
};

template <typename T, int V>
struct VarSum {  // pass 2: sum (x - mean)^2, mean from pass 1's totals
  static constexpr int kQ = 1;
  static constexpr bool kCount = false;
  const T* x;
  const float* stats;  // pass 1: sums [C], count at [C]
  struct Ctx {
    float mean[V];
  };
  __device__ Ctx prepare(int c0, int c) const {
    Ctx k;
    const float n = fmaxf(stats[c], 1.f);
#pragma unroll
    for (int i = 0; i < V; ++i) k.mean[i] = stats[c0 + i] / n;
    return k;
  }
  __device__ void row(const Ctx& k, long long r, int c0, int c,
                      float (&t)[kQ][V]) const {
    float v[V];
    load_vec<V>(x + r * c + c0, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = __fsub_rn(v[i], k.mean[i]);
      t[0][i] = __fmul_rn(d, d);
    }
  }
};

template <typename T, int V>
struct GradSums {  // backward: sum g and sum g * x^
  static constexpr int kQ = 2;
  static constexpr bool kCount = false;
  const T* dy;
  const T* x;
  const T* y;          // the output where the norm ends in a ReLU, else null
  const float* save;   // mean [C], rstd [C], n
  struct Ctx {
    float mean[V], rstd[V];
  };
  __device__ Ctx prepare(int c0, int c) const {
    Ctx k;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      k.mean[i] = save[c0 + i];
      k.rstd[i] = save[c + c0 + i];
    }
    return k;
  }
  __device__ void row(const Ctx& k, long long r, int c0, int c,
                      float (&t)[kQ][V]) const {
    const long long o = r * c + c0;
    float g[V], xv[V], yv[V];
    load_vec<V>(dy + o, g);
    load_vec<V>(x + o, xv);
    if (y != nullptr) {
      load_vec<V>(y + o, yv);
#pragma unroll
      for (int i = 0; i < V; ++i) g[i] = yv[i] > 0.f ? g[i] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      t[0][i] = g[i];
      t[1][i] = g[i] * normalised(xv[i], k.mean[i], k.rstd[i]);
    }
  }
};

// Sums Op's terms over the valid rows into out [kQ, C] (and the count of
// valid rows into out[kQ * C] where Op::kCount).  grid (parts, chunks),
// block (tx, ty); row block p takes rows [p * rows_per_part, ...).
// part: kQ * parts * cpad floats, part_count: parts ints; tickets: chunks
// ints, 0 on entry and left 0.
template <typename T, int V, class Op>
__global__ void __launch_bounds__(kThreads)
norm_reduce_kernel(Op op, const uint8_t* __restrict__ valid,
                   float* __restrict__ part, int* __restrict__ part_count,
                   int* __restrict__ tickets, float* __restrict__ out,
                   int rows, int c, int rows_per_part) {
  constexpr int Q = Op::kQ;
  __shared__ float red[Q * kThreads * V];
  __shared__ int cred[kThreads];
  __shared__ bool last;
  const int parts = gridDim.x;
  const int cpad = gridDim.y * blockDim.x * V;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  const bool active = c0 < c;  // lane 0 of a chunk always is
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_part;
  const long long r1 = min(static_cast<long long>(rows), r0 + rows_per_part);

  float acc[Q][V];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[q][i] = 0.f;
  int n = 0;
  if (active) {
    const typename Op::Ctx k = op.prepare(c0, c);
#pragma unroll 4
    for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      const bool m = valid[r] != 0;
      float t[Q][V];
      op.row(k, r, c0, c, t);
      n += m;
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[q][i] += m ? t[q][i] : 0.f;
    }
  }
  block_sum<Q, V>(acc, red);
  if (Op::kCount) n = block_count(n, cred);
  if (threadIdx.y == 0 && active) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int i = 0; i < V; ++i)
        part[(static_cast<size_t>(q) * parts + blockIdx.x) * cpad + c0 + i] =
            acc[q][i];
  }
  if (Op::kCount && blockIdx.y == 0 && threadIdx.x == 0 && threadIdx.y == 0)
    part_count[blockIdx.x] = n;

  // the last row block of the chunk sums the partials, in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0)
    last = atomicAdd(tickets + blockIdx.y, 1) == parts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[q][i] = 0.f;
  n = 0;
  if (active) {
#pragma unroll 4
    for (int p = threadIdx.y; p < parts; p += blockDim.y) {
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int i = 0; i < V; ++i)
          acc[q][i] += __ldcg(
              part + (static_cast<size_t>(q) * parts + p) * cpad + c0 + i);
      if (Op::kCount) n += __ldcg(part_count + p);
    }
  }
  block_sum<Q, V>(acc, red);
  if (Op::kCount) n = block_count(n, cred);
  if (threadIdx.y == 0 && active) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int i = 0; i < V; ++i) out[q * c + c0 + i] = acc[q][i];
  }
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    if (Op::kCount && blockIdx.y == 0) out[Q * c] = static_cast<float>(n);
    tickets[blockIdx.y] = 0;  // for the next reduction of this call
  }
}

// ------------------------------------------------------ apply, gradient

// y = relu?(T(T(bn(x)) + residual)), 0 + residual on padding rows.
// stats1 / stats2 (train: pass 1's sums and count, pass 2's sums; null in
// eval, where the running statistics normalise).  Row block 0 writes
// save = (mean [C], rstd [C], n) and, in train mode, moves the running
// statistics.  grid (blocks, chunks), block (tx, ty); rows grid-strided.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
norm_apply_kernel(const T* __restrict__ x, const uint8_t* __restrict__ valid,
                  const T* __restrict__ residual,
                  const float* __restrict__ weight,
                  const float* __restrict__ bias,
                  const float* __restrict__ stats1,
                  const float* __restrict__ stats2, float* running_mean,
                  float* running_var, T* __restrict__ out,
                  float* __restrict__ save, int rows, int c, float eps,
                  float momentum, int relu) {
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c0 >= c) return;
  const bool train = stats1 != nullptr;
  const bool first = blockIdx.x == 0 && threadIdx.y == 0;
  const float n = train ? fmaxf(stats1[c], 1.f) : 1.f;
  float mean[V], rstd[V], w[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = c0 + i;
    const float mu = train ? stats1[ch] / n : running_mean[ch];
    const float var = train ? stats2[ch] / n : running_var[ch];
    mean[i] = mu;
    rstd[i] = __fdiv_rn(1.f, __fsqrt_rn(var + eps));  // as the CPU's rsqrt
    w[i] = weight[ch];
    b[i] = bias[ch];
    if (first) {
      save[ch] = mu;
      save[c + ch] = rstd[i];
      if (train) {
        const float keep = 1.f - momentum;
        const float unbiased = var * n / fmaxf(n - 1.f, 1.f);
        running_mean[ch] = keep * running_mean[ch] + momentum * mu;
        running_var[ch] = keep * running_var[ch] + momentum * unbiased;
      }
    }
  }
  if (first && c0 == 0) save[2 * c] = n;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
#pragma unroll 2
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.y +
                     threadIdx.y;
       r < rows; r += step) {
    const long long o = r * c + c0;
    const bool m = valid[r] != 0;
    float v[V], res[V];
    load_vec<V>(x + o, v);
    if (residual != nullptr) load_vec<V>(residual + o, res);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float t = m ? round_to<T>(__fadd_rn(
                        __fmul_rn(normalised(v[i], mean[i], rstd[i]), w[i]),
                        b[i]))
                  : 0.f;
      if (residual != nullptr) t = round_to<T>(t + res[i]);
      if (relu) t = t < 0.f ? 0.f : t;
      v[i] = t;
    }
    store_vec<V>(out + o, v);
  }
}

// dx = valid ? w * rstd * (g - mg - x^ * mgx) : 0 with mg, mgx the
// backward sums over n (gsum [2, C]: sum g, sum g * x^; train), or
// w * rstd * g (gsum null: eval); dres = g on every row (null: no
// residual).  grid and block as the apply kernel's.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
norm_grad_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                 const T* __restrict__ y, const uint8_t* __restrict__ valid,
                 const float* __restrict__ weight,
                 const float* __restrict__ save,
                 const float* __restrict__ gsum, T* __restrict__ dx,
                 T* __restrict__ dres, int rows, int c) {
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c0 >= c) return;
  const float n = save[2 * c];
  float mean[V], rstd[V], a[V], mg[V], mgx[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = c0 + i;
    mean[i] = save[ch];
    rstd[i] = save[c + ch];
    a[i] = weight[ch] * rstd[i];
    mg[i] = gsum != nullptr ? gsum[ch] / n : 0.f;
    mgx[i] = gsum != nullptr ? gsum[c + ch] / n : 0.f;
  }
  const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
#pragma unroll 2
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.y +
                     threadIdx.y;
       r < rows; r += step) {
    const long long o = r * c + c0;
    const bool m = valid[r] != 0;
    float g[V], xv[V], yv[V];
    load_vec<V>(dy + o, g);
    load_vec<V>(x + o, xv);
    if (y != nullptr) {
      load_vec<V>(y + o, yv);
#pragma unroll
      for (int i = 0; i < V; ++i) g[i] = yv[i] > 0.f ? g[i] : 0.f;
    }
    if (dres != nullptr) store_vec<V>(dres + o, g);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xh = normalised(xv[i], mean[i], rstd[i]);
      xv[i] = m ? a[i] * (g[i] - mg[i] - xh * mgx[i]) : 0.f;
    }
    store_vec<V>(dx + o, xv);
  }
}

// ------------------------------------------------------------- launches

struct Geometry {
  int vec, tx, ty, chunks, blocks, rows_per_part;
};

template <typename T>
bool geometry_ok(const Geometry& g, int rows, int c) {
  const bool pow2 = g.ty > 0 && (g.ty & (g.ty - 1)) == 0;
  return rows >= 0 && c >= 1 && g.vec >= 1 && g.vec * sizeof(T) <= 16 &&
         (g.vec & (g.vec - 1)) == 0 && c % g.vec == 0 && g.tx >= 1 && pow2 &&
         g.tx * g.ty <= kThreads && g.chunks >= 1 && g.chunks <= 65535 &&
         static_cast<long long>(g.chunks) * g.tx * g.vec >= c &&
         static_cast<long long>(g.chunks - 1) * g.tx * g.vec < c &&
         g.blocks >= 1 && g.rows_per_part >= 1;
}

// f(std::integral_constant<int, V>) for the geometry's V.
template <typename T, class F>
cudaError_t with_vec(int vec, F&& f) {
  switch (vec) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8:
      if constexpr (sizeof(T) == 2) return f(std::integral_constant<int, 8>{});
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, template <typename, int> class OpT, class Make>
cudaError_t launch_reduce(const Geometry& g, Make make,
                          const uint8_t* valid, float* part, int* part_count,
                          int* tickets, float* out, int rows, int c,
                          cudaStream_t stream) {
  return with_vec<T>(g.vec, [&](auto v) {
    constexpr int V = decltype(v)::value;
    const dim3 grid(g.blocks, g.chunks), block(g.tx, g.ty);
    norm_reduce_kernel<T, V, OpT<T, V>><<<grid, block, 0, stream>>>(
        make(v), valid, part, part_count, tickets, out, rows, c,
        g.rows_per_part);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t norm_sum(const void* x, const uint8_t* valid, float* part,
                     int* part_count, int* tickets, float* stats, int rows,
                     int c, const Geometry& g, cudaStream_t stream) {
  if (!geometry_ok<T>(g, rows, c)) return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaMemsetAsync(tickets, 0, g.chunks * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  return launch_reduce<T, MeanSum>(
      g, [&](auto v) { return MeanSum<T, decltype(v)::value>{xt}; }, valid,
      part, part_count, tickets, stats, rows, c, stream);
}

template <typename T>
cudaError_t norm_var(const void* x, const uint8_t* valid, const float* stats1,
                     float* part, int* tickets, float* stats2, int rows, int c,
                     const Geometry& g, cudaStream_t stream) {
  if (!geometry_ok<T>(g, rows, c)) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  return launch_reduce<T, VarSum>(
      g, [&](auto v) { return VarSum<T, decltype(v)::value>{xt, stats1}; },
      valid, part, nullptr, tickets, stats2, rows, c, stream);
}

template <typename T>
cudaError_t norm_grad_sums(const void* dy, const void* x, const void* y,
                           const uint8_t* valid, const float* save,
                           float* part, int* tickets, float* gsum, int rows,
                           int c, const Geometry& g, cudaStream_t stream) {
  if (!geometry_ok<T>(g, rows, c)) return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaMemsetAsync(tickets, 0, g.chunks * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const T* dyt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  return launch_reduce<T, GradSums>(
      g,
      [&](auto v) {
        return GradSums<T, decltype(v)::value>{dyt, xt, yt, save};
      },
      valid, part, nullptr, tickets, gsum, rows, c, stream);
}

template <typename T>
cudaError_t norm_apply(const void* x, const uint8_t* valid,
                       const void* residual, const float* weight,
                       const float* bias, const float* stats1,
                       const float* stats2, float* running_mean,
                       float* running_var, void* out, float* save, int rows,
                       int c, const Geometry& g, float eps, float momentum,
                       int relu, cudaStream_t stream) {
  if (!geometry_ok<T>(g, rows, c)) return cudaErrorInvalidValue;
  return with_vec<T>(g.vec, [&](auto v) {
    constexpr int V = decltype(v)::value;
    const dim3 grid(g.blocks, g.chunks), block(g.tx, g.ty);
    norm_apply_kernel<T, V><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), valid, static_cast<const T*>(residual),
        weight, bias, stats1, stats2, running_mean, running_var,
        static_cast<T*>(out), save, rows, c, eps, momentum, relu);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t norm_grad(const void* dy, const void* x, const void* y,
                      const uint8_t* valid, const float* weight,
                      const float* save, const float* gsum, void* dx,
                      void* dres, int rows, int c, const Geometry& g,
                      cudaStream_t stream) {
  if (!geometry_ok<T>(g, rows, c)) return cudaErrorInvalidValue;
  return with_vec<T>(g.vec, [&](auto v) {
    constexpr int V = decltype(v)::value;
    const dim3 grid(g.blocks, g.chunks), block(g.tx, g.ty);
    norm_grad_kernel<T, V><<<grid, block, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x),
        static_cast<const T*>(y), valid, weight, save, gsum,
        static_cast<T*>(dx), static_cast<T*>(dres), rows, c);
    return cudaGetLastError();
  });
}

}  // namespace bn
}  // namespace mrcc

// ------------------------------------------------------------ C interface
//
// x, y, dy, dx, residual, dres: [rows, c] in the function's dtype; valid:
// [rows] bool; weight, bias, running_mean, running_var: [c] f32; part /
// part_count / tickets: the reductions' scratch (ops/norm.py sizes it from
// the geometry); stats1 [c + 1] (sums, count), stats2 [c], save
// [2c + 1] (mean, rstd, n), gsum [2, c].  Each returns cudaGetLastError()
// (cudaErrorInvalidValue for a geometry the kernels do not take).

#define MRCC_NORM_GEOMETRY \
  int vec, int tx, int ty, int chunks, int blocks, int rows_per_part
#define MRCC_NORM_G \
  mrcc::bn::Geometry { vec, tx, ty, chunks, blocks, rows_per_part }

#define MRCC_NORM_EXPORT(SUFFIX, T)                                          \
  extern "C" int mrcc_norm_sum_##SUFFIX(                                     \
      const void* x, const uint8_t* valid, float* part, int* part_count,     \
      int* tickets, float* stats1, int rows, int c, MRCC_NORM_GEOMETRY,      \
      cudaStream_t stream) {                                                 \
    return static_cast<int>(mrcc::bn::norm_sum<T>(                           \
        x, valid, part, part_count, tickets, stats1, rows, c, MRCC_NORM_G,   \
        stream));                                                            \
  }                                                                          \
  extern "C" int mrcc_norm_var_##SUFFIX(                                     \
      const void* x, const uint8_t* valid, const float* stats1, float* part, \
      int* tickets, float* stats2, int rows, int c, MRCC_NORM_GEOMETRY,      \
      cudaStream_t stream) {                                                 \
    return static_cast<int>(mrcc::bn::norm_var<T>(                           \
        x, valid, stats1, part, tickets, stats2, rows, c, MRCC_NORM_G,       \
        stream));                                                            \
  }                                                                          \
  extern "C" int mrcc_norm_apply_##SUFFIX(                                   \
      const void* x, const uint8_t* valid, const void* residual,             \
      const float* weight, const float* bias, const float* stats1,           \
      const float* stats2, float* running_mean, float* running_var,          \
      void* out, float* save, int rows, int c, MRCC_NORM_GEOMETRY,           \
      float eps, float momentum, int relu, cudaStream_t stream) {            \
    return static_cast<int>(mrcc::bn::norm_apply<T>(                         \
        x, valid, residual, weight, bias, stats1, stats2, running_mean,      \
        running_var, out, save, rows, c, MRCC_NORM_G, eps, momentum, relu,   \
        stream));                                                            \
  }                                                                          \
  extern "C" int mrcc_norm_grad_sums_##SUFFIX(                               \
      const void* dy, const void* x, const void* y, const uint8_t* valid,    \
      const float* save, float* part, int* tickets, float* gsum, int rows,   \
      int c, MRCC_NORM_GEOMETRY, cudaStream_t stream) {                      \
    return static_cast<int>(mrcc::bn::norm_grad_sums<T>(                     \
        dy, x, y, valid, save, part, tickets, gsum, rows, c, MRCC_NORM_G,    \
        stream));                                                            \
  }                                                                          \
  extern "C" int mrcc_norm_grad_##SUFFIX(                                    \
      const void* dy, const void* x, const void* y, const uint8_t* valid,    \
      const float* weight, const float* save, const float* gsum, void* dx,   \
      void* dres, int rows, int c, MRCC_NORM_GEOMETRY, cudaStream_t stream) { \
    return static_cast<int>(mrcc::bn::norm_grad<T>(                         \
        dy, x, y, valid, weight, save, gsum, dx, dres, rows, c, MRCC_NORM_G, \
        stream));                                                            \
  }

MRCC_NORM_EXPORT(f32, float)
MRCC_NORM_EXPORT(bf16, __nv_bfloat16)
