// B10 — nearest valid target of every template point (the ICP inner loop).
//
// Replaces: mrcc_tpu/ops/nn_pallas.py::nn_search_pallas (_nn_kernel).
//
//   per item b and template point i, over targets j:
//     d2[j] = |a_i|^2 - 2 a_i . b'_j + s_j,
//     b'_j = valid_j ? b_j : 0,   s_j = valid_j ? |b_j|^2 : 1e30,
//     idx[b, i] = smallest j with d2[j] == min_j d2[j],  d2[b, i] = that min.
//
// This is the TPU kernel's own formula (not the |a|^2 + |b|^2 - 2ab of the
// plain ICP), including its 1e30 for invalid targets.
//
// Bound on the card: operations, M * N distance evaluations of ~8 f32
// operations each (the inputs are 16 bytes a point).  Design: one thread
// per template point keeps its running minimum in registers; the item's
// targets stream through shared memory in tiles of 1024 (x, y, z, s)
// float4s, read once per CTA; the scan runs in ascending j and replaces the
// minimum only on a strictly smaller d2, which gives the first index of the
// minimum.  First version: CUDA-core FMA, no tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 1024;

__global__ void __launch_bounds__(THREADS)
nn_kernel(const float* __restrict__ tmpl, const float* __restrict__ target,
          const uint8_t* __restrict__ mask, int* __restrict__ idx,
          float* __restrict__ d2_out, int m, int n) {
  __shared__ float4 tile[TILE];
  const int b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const float* a = tmpl + (static_cast<size_t>(b) * m + min(i, m - 1)) * 3;
  const float ax = a[0], ay = a[1], az = a[2];
  const float sqs = ax * ax + ay * ay + az * az;
  const float* tb = target + static_cast<size_t>(b) * n * 3;
  const uint8_t* mb = mask + static_cast<size_t>(b) * n;

  float best = 0.f;
  int best_j = 0;
  for (int j0 = 0; j0 < n; j0 += TILE) {
    const int len = min(TILE, n - j0);
    __syncthreads();
    for (int e = threadIdx.x; e < len; e += THREADS) {
      const int j = j0 + e;
      const bool ok = mb[j] != 0;
      const float x = ok ? tb[3 * j] : 0.f;
      const float y = ok ? tb[3 * j + 1] : 0.f;
      const float z = ok ? tb[3 * j + 2] : 0.f;
      tile[e] = make_float4(x, y, z, ok ? x * x + y * y + z * z : 1e30f);
    }
    __syncthreads();
    for (int e = 0; e < len; ++e) {
      const float4 t = tile[e];
      const float st = ax * t.x + ay * t.y + az * t.z;
      const float d = (sqs - 2.f * st) + t.w;
      if (j0 + e == 0 || d < best) {
        best = d;
        best_j = j0 + e;
      }
    }
  }
  if (i < m) {
    idx[static_cast<size_t>(b) * m + i] = best_j;
    d2_out[static_cast<size_t>(b) * m + i] = best;
  }
}

}  // namespace

// template [B, m, 3] f32, target [B, n, 3] f32, mask [B, n] bool,
// idx [B, m] int32, d2 [B, m] f32 (m, n >= 1).  Returns cudaGetLastError().
extern "C" int mrcc_nn_search(const float* tmpl, const float* target,
                              const uint8_t* mask, int* idx, float* d2,
                              int batch, int m, int n, cudaStream_t stream) {
  if (m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0) {
    const dim3 grid((m + THREADS - 1) / THREADS, batch);
    nn_kernel<<<grid, THREADS, 0, stream>>>(tmpl, target, mask, idx, d2, m,
                                            n);
  }
  return static_cast<int>(cudaGetLastError());
}
