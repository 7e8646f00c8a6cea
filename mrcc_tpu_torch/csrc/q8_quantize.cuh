// The int8 convs' quantisation (B6, B7: the quantising part of the JAX
// wrappers gather_gemm_conv_sk_q8 / gather_gemm_conv_tiled_q8), as kernels
// that write the operands in the layout the int8 tiles read (q8_mma.cuh):
//
//   s_c = max(absmax_c, 1e-8) * f32(1 / 127)        per input channel c
//   q[r, c]  = clip(rint(x[r, c] / s_c), -127, 127)  -> q  [rows, cpad]
//   W'       = W[k, c, n] * s_c
//   m[g, n]  = max(max |W'_g[., ., n]|, 1e-12) * f32(1 / 127)  (per group g
//              of channels; per octant too: m[g, k, n] for the up conv)
//   wq[k, n, c] = clip(rint(W'[k, c, n] / m), -127, 127)  -> wq [K, Cout, cpad]
//
// absmax is the calibrated one, or the column max of |x| over every row
// (act_absmax_q8_kernel: atomicMax on the bits of non-negative floats,
// exact in any order; so are the weights' column maxima).  cpad is cin
// rounded up to 16 (whole 16-byte chunks); the bytes past cin are 0 in q
// and in wq.  The
// arithmetic is the plain twin's (ops/conv_q8.py, the jitted JAX wrapper's):
// true divisions (__fdiv_rn), products rounded on their own (__fmul_rn, no
// contraction into an FMA), rounding half to even (rintf).
//
// Bound: bytes (x read once, q written once; W read twice, wq written
// once).  A memset, then two launches (three with the dynamic absmax, its
// column max first): quantize_q8_kernel writes q (four channels, one int32
// word, a thread) in some blocks and takes the weights' column maxima in
// the others (one block per 32 columns, group and offset: a block per
// (columns, group) alone left most SMs idle at the main path's widths);
// quantize_w_q8_kernel writes wq, each column's 16 channels as one 16-byte
// store, with the same blocks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mrcc {
namespace q8 {

constexpr float kInv127 = static_cast<float>(1.0 / 127.0);
constexpr float kActFloor = static_cast<float>(1e-8);
constexpr float kWFloor = static_cast<float>(1e-12);

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float act_scale(float amax) {
  return __fmul_rn(fmaxf(amax, kActFloor), kInv127);
}

// clip(rint(v / s), -127, 127) as a byte
__device__ __forceinline__ uint32_t quant(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(r)));
}

// amax_bits[c] = max(amax_bits[c], bits of |x[r, c]|) over the block's rows.
// grid (ceil(c / 32), row blocks), 256 threads: lane = column, 8 row
// phases; amax_bits zero before the launch.
template <typename T>
__global__ void __launch_bounds__(256)
act_absmax_q8_kernel(const T* __restrict__ x, unsigned* __restrict__ amax_bits,
                     int rows, int c) {
  __shared__ float part[8][32];
  const int lane = threadIdx.x & 31;
  const int ph = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float mx = 0.f;
  if (col < c) {
    for (long long r = static_cast<long long>(blockIdx.y) * 8 + ph; r < rows;
         r += static_cast<long long>(gridDim.y) * 8)
      mx = fmaxf(mx, fabsf(to_float(x[r * c + col])));
  }
  part[ph][lane] = mx;
  __syncthreads();
  if (ph == 0 && col < c) {
#pragma unroll
    for (int p = 1; p < 8; ++p) mx = fmaxf(mx, part[p][lane]);
    atomicMax(amax_bits + col, __float_as_uint(mx));
  }
}

// The quantisation pass's second launch, two roles by block: blocks
// [0, act_blocks) write q [rows, cpad], one int32 word (four channels) a
// thread, grid-stride, s_c staged in shared memory (dynamic, cpad floats);
// the blocks after them take the weights' column maxima, one block per
// (32 output columns, group g, offset k): max |W * s_c| over the group's
// channels of offset k, atomicMax into wmax_bits [G, K or 1, cout] (zero
// before the launch; the bits of non-negative floats order as unsigned).
template <typename T>
__global__ void __launch_bounds__(256)
quantize_q8_kernel(const T* __restrict__ x, const float* __restrict__ amax,
                   uint32_t* __restrict__ q, int rows, int c, int cpad,
                   int act_blocks, const float* __restrict__ w,
                   unsigned* __restrict__ wmax_bits, int taps, int cout,
                   int gw, int ng, int per_octant) {
  extern __shared__ float s_c[];
  __shared__ float part[8][32];
  if (static_cast<int>(blockIdx.x) < act_blocks) {
    for (int i = threadIdx.x; i < c; i += blockDim.x)
      s_c[i] = act_scale(amax[i]);
    __syncthreads();
    const int words = cpad / 4;
    const long long total = static_cast<long long>(rows) * words;
    for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         e < total; e += static_cast<long long>(act_blocks) * blockDim.x) {
      const long long r = e / words;
      const int c0 = static_cast<int>(e - r * words) * 4;
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = c0 + j;
        if (ch < c) word |= quant(to_float(x[r * c + ch]), s_c[ch]) << (8 * j);
      }
      q[e] = word;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int blk = blockIdx.x - act_blocks;  // (column tile, group, offset)
  const int tiles = (cout + 31) / 32;
  const int col = (blk % tiles) * 32 + lane;
  blk /= tiles;
  const int g = blk % ng;
  const int k = blk / ng;
  const int a = g * gw;
  const int b = g == ng - 1 ? c : a + gw;
  float mx = 0.f;
  if (col < cout) {
    for (int ch = a + warp; ch < b; ch += 8)
      mx = fmaxf(mx, fabsf(__fmul_rn(
                         __ldg(w + (static_cast<size_t>(k) * c + ch) * cout +
                               col),
                         act_scale(__ldg(amax + ch)))));
  }
  part[warp][lane] = mx;
  __syncthreads();
  if (warp == 0 && col < cout) {
#pragma unroll
    for (int p = 1; p < 8; ++p) mx = fmaxf(mx, part[p][lane]);
    const size_t at =
        (static_cast<size_t>(g) * (per_octant ? taps : 1) +
         (per_octant ? k : 0)) * cout + col;
    atomicMax(wmax_bits + at, __float_as_uint(mx));
  }
}

// The last launch: one block per (32 output columns, group g, offset k)
// writes wq[k, n, c] for the group's channels in 16-channel chunks, one
// 16-byte store a chunk (the last group's chunks run on to cpad, writing
// its zero padding), with m = max(wmax, 1e-12) * f32(1 / 127); the blocks
// of offset 0 (every offset per octant) write m [G, cout] ([G, K, cout]).
// grid (ceil(cout / 32), G, K), 256 threads.
__global__ void __launch_bounds__(256)
quantize_w_q8_kernel(const float* __restrict__ w,
                     const float* __restrict__ amax,
                     const unsigned* __restrict__ wmax_bits,
                     int8_t* __restrict__ wq, float* __restrict__ m,
                     int taps, int cin, int cout, int cpad, int gw,
                     int per_octant) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int g = blockIdx.y;
  const int k = blockIdx.z;
  if (col >= cout) return;
  const int a = g * gw;
  const bool last = g == gridDim.y - 1;
  const int b = last ? cin : a + gw;
  const int chunks = ((last ? cpad : b) - a) / 16;
  const size_t at = (static_cast<size_t>(g) * (per_octant ? taps : 1) +
                     (per_octant ? k : 0)) * cout + col;
  const float s =
      __fmul_rn(fmaxf(__uint_as_float(wmax_bits[at]), kWFloor), kInv127);
  if (warp == 0 && (per_octant || k == 0)) m[at] = s;
  for (int p = warp; p < chunks; p += 8) {
    const int c0 = a + p * 16;
    uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int ch = c0 + j;
      if (ch < b) {
        const float v = __fmul_rn(
            __ldg(w + (static_cast<size_t>(k) * cin + ch) * cout + col),
            act_scale(__ldg(amax + ch)));
        words[j / 4] |= quant(v, s) << (8 * (j % 4));
      }
    }
    *reinterpret_cast<uint4*>(
        wq + (static_cast<size_t>(k) * cout + col) * cpad + c0) =
        make_uint4(words[0], words[1], words[2], words[3]);
  }
}

// Floats of the pass's scratch: the dynamic absmax [cin], then the weights'
// column maxima [ng, per_octant ? taps : 1, cout].
inline size_t scratch_floats(int cin, int taps, int cout, int ng,
                             int per_octant) {
  return static_cast<size_t>(cin) +
         static_cast<size_t>(ng) * (per_octant ? taps : 1) * cout;
}

// The whole pass: q, wq and m from x [rows, cin] (T) and w [K, cin, cout]
// f32, with the calibrated act_absmax or (null) the dynamic one.  scratch:
// scratch_floats(...) floats.  Groups of gw channels, the last ending at
// cin (ng of them).  A memset and two launches (three with the dynamic
// absmax).  Returns the first CUDA error.
template <typename T>
cudaError_t launch_quantize(const void* x, const float* act_absmax,
                            const float* w, float* scratch, void* q,
                            void* wq, float* m, int rows, int cin, int cpad,
                            int taps, int cout, int gw, int ng,
                            int per_octant, cudaStream_t stream) {
  if (cin <= 0 || cpad % 16 != 0 || cpad < cin || gw % 16 != 0 || ng <= 0 ||
      taps <= 0 || cout <= 0 || rows < 0)
    return cudaErrorInvalidValue;
  const bool dynamic = act_absmax == nullptr;
  float* wmax = scratch + cin;
  // zero the weights' maxima (and the dynamic absmax before them)
  cudaError_t err = cudaMemsetAsync(
      dynamic ? scratch : wmax,
      0, (scratch_floats(cin, taps, cout, ng, per_octant) - (dynamic ? 0 : cin))
             * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const float* amax = dynamic ? scratch : act_absmax;
  if (dynamic && rows > 0) {
    const int yb = (rows + 8 * 64 - 1) / (8 * 64);
    act_absmax_q8_kernel<T><<<dim3((cin + 31) / 32, yb < 1024 ? yb : 1024),
                              256, 0, stream>>>(
        static_cast<const T*>(x), reinterpret_cast<unsigned*>(scratch), rows,
        cin);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long words = static_cast<long long>(rows) * (cpad / 4);
  const long long want = (words + 255) / 256;
  const int act_blocks = static_cast<int>(want < 4096 ? want : 4096);
  const long long w_blocks = static_cast<long long>((cout + 31) / 32) * ng *
                             taps;
  quantize_q8_kernel<T><<<static_cast<unsigned>(act_blocks + w_blocks), 256,
                          cpad * sizeof(float), stream>>>(
      static_cast<const T*>(x), amax, static_cast<uint32_t*>(q), rows, cin,
      cpad, act_blocks, w, reinterpret_cast<unsigned*>(wmax), taps, cout, gw,
      ng, per_octant);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quantize_w_q8_kernel<<<dim3((cout + 31) / 32, ng, taps), 256, 0, stream>>>(
      w, amax, reinterpret_cast<const unsigned*>(wmax),
      static_cast<int8_t*>(wq), m, taps, cin, cout, cpad, gw, per_octant);
  return cudaGetLastError();
}

}  // namespace q8
}  // namespace mrcc
