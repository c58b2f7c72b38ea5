// Training-mode batch norm over NCHW float32, and the swish that follows it
// where one does: the forward (batch statistics, running statistics, the
// normalised output) and the backward (input, weight and bias gradients) of
// ops/batch_norm.py::batch_norm_train.
//
// Replaces no TPU kernel: the JAX package leaves batch norm to XLA, which
// fuses it into the convolutions' neighbours on the TPU.  Added because in
// the port's train step the training-mode batch norms and swishes, as
// separate PyTorch ops, were about 74 % of the step's ops and bytes (153
// sites, about 45 ops each with autograd's, every one a pass over the
// activation or a broadcast of a per-channel vector).
//
// Bound: bytes.  A few operations per element against 4 bytes read or
// written.  The least the work needs: the forward reads x once and writes y
// once, the backward reads the upstream gradient and x once and writes dx
// once.  The forward here reads x twice (statistics, then the output) and
// the backward reads g and x twice (sums, then dx): the second read of a
// small site comes from L2 (50 MB), of a large one from device memory.
//
// Design (float4 loads where H x W is a multiple of 4 and the pointers are
// 16-byte aligned, one float at a time otherwise; 256 threads a block):
//  forward
//   1. bn_stats_partial_kernel, grid (chunks, C): block (j, c) sums x and x^2
//      over chunk j of channel c's N planes of H x W (a contiguous range of
//      the channel's elements taken plane by plane) and writes the two
//      partial sums.  The wrapper picks the chunk so that the grid has about
//      1,024 blocks, 1 to 16 float4 loads a thread.
//   2. bn_stats_sum_kernel, a warp per channel: the channel's partial sums added
//      in a fixed order (lane l takes partials l, l + 32, ...; then a fixed
//      shuffle tree), mean = sum / n, mean_sq = sum_sq / n; without a mesh
//      (FINALIZE) it goes on to finalize_channel, else the wrapper
//      all-reduces (mean, mean_sq) over the mesh and launches
//   3. bn_finalize_kernel, a thread per channel: finalize_channel, the variance
//      E[x^2] - E[x]^2, rstd = rsqrt(var + eps), inv = rstd * weight and,
//      where asked, the running statistics.
//   4. bn_apply_kernel: y = (x - mean) * inv + bias, then y * sigmoid(y) with
//      SWISH; one read of x and one write.
//  backward (g the upstream gradient; y recomputed from x, never stored)
//   1. bn_grad_partial_kernel, grid (chunks, C): g' = g * swish'(y) (g without
//      SWISH) and the partial sums of g' and g' * (x - mean).
//   2. bn_grad_sum_kernel, a warp per channel: the channel's sums S1, S2 in a
//      fixed order; without a mesh (FINALIZE) it goes on to
//      grad_coefficients, else the wrapper all-reduces (S1, S2) (their mean
//      over the ranks) and launches
//   3. bn_grad_coef_kernel, a thread per channel: grad_coefficients.
//   4. bn_grad_apply_kernel: dx = g' * inv + a + b * (x - mean).
//  No atomics: every sum is taken in the same order on every run, so a
//  replay of a CUDA graph, or the recompute of a checkpointed block, gives
//  the same bits as the call before.
//
// Numerics.  Every elementwise step is written with _rn intrinsics in the
// plain version's order (nn/core.py, ops/batch_norm.py::
// batch_norm_train_reference): (x - mean) * inv + bias rounded after each
// op, the sigmoid as 1 / (1 + expf(-y)) (expf is the libdevice function that
// PyTorch's CUDA exp calls, the division IEEE, as PyTorch's reciprocal), and
// y * s.  So given the plain version's mean and inv the output is bit-equal
// to it.  The statistics are sums in another order than PyTorch's
// reductions, so they agree to float32 rounding, not bit for bit.  The
// running statistics use the plain version's operations: (1 - m) * running +
// m * mean, and (1 - m) * running + (m * var) * (n / (n - 1)), each product
// rounded.  The backward is the plain version's gradient: with
// rstd = rsqrt(var + eps), S1 = sum g', S2 = sum g' * (x - mean) over the
// rank's n elements, and S1', S2' their means over the mesh's ranks,
//   dbias = S1, dweight = S2 * rstd,
//   dvar = -0.5 * weight * rstd^3 * S2',
//   dx = g' * inv + (-inv * S1') / n + (2 * dvar / n) * (x - mean),
// where swish'(y) = s + y * s * (1 - s), s (1 - s) the sigmoid's derivative
// as nn/core.py::_Sigmoid takes it.
//
// Interface: plain C (no PyTorch headers), loaded with ctypes.  Each
// launcher takes device pointers and the caller's stream, allocates nothing
// (the wrapper passes the scratch for the partial sums), does not
// synchronise and returns cudaGetLastError() of its launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // ops/batch_norm.py's THREADS
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <int V>
__device__ __forceinline__ void load(const float* p, float (&r)[V]) {
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else {
    r[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&r)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    p[0] = r[0];
  }
}

// The element offset of unit u (V elements) of channel c: plane u / hwv of
// the channel, offset u % hwv in it.
__device__ __forceinline__ int64_t channel_offset(uint32_t u, uint32_t hwv, int64_t c, int64_t channels) {
  const uint32_t plane = u / hwv;
  return ((int64_t)plane * channels + c) * hwv + (u - plane * hwv);
}

__device__ __forceinline__ float sigmoid(float y) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y)));
}

// The forward output of one element; xc = x - mean for the caller.
template <bool SWISH>
__device__ __forceinline__ float output(float x, float mean, float inv, float bias) {
  const float y = __fadd_rn(__fmul_rn(__fsub_rn(x, mean), inv), bias);
  return SWISH ? __fmul_rn(y, sigmoid(y)) : y;
}

// g' (the gradient reaching the normalised y) of one element, and x - mean.
template <bool SWISH>
__device__ __forceinline__ float grad_in(float x, float g, float mean, float inv, float bias, float& xc) {
  xc = __fsub_rn(x, mean);
  if (!SWISH) {
    return g;
  }
  const float y = __fadd_rn(__fmul_rn(xc, inv), bias);
  const float s = sigmoid(y);
  // d(y * s) = g * s + (g * y) * s (1 - s)
  return __fadd_rn(__fmul_rn(g, s), __fmul_rn(__fmul_rn(g, y), __fmul_rn(s, __fsub_rn(1.0f, s))));
}

// The sums (a, b) of the block's threads, in a fixed order; valid in thread 0.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 warp_sums[kWarps];
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    warp_sums[warp] = make_float2(a, b);
  }
  __syncthreads();
  if (warp == 0) {
    const float2 v = lane < kWarps ? warp_sums[lane] : make_float2(0.0f, 0.0f);
    a = v.x;
    b = v.y;
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      a += __shfl_xor_sync(kFull, a, o);
      b += __shfl_xor_sync(kFull, b, o);
    }
  }
  return make_float2(a, b);
}

// The sums of a channel's partials, by one warp in a fixed order; every lane
// gets them.
__device__ __forceinline__ float2 warp_sum_partials(const float2* __restrict__ partial, int64_t chunks) {
  float a = 0.0f, b = 0.0f;
  for (int64_t j = threadIdx.x & 31; j < chunks; j += 32) {
    const float2 p = partial[j];
    a += p.x;
    b += p.y;
  }
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
  return make_float2(a, b);
}

// stats rows: 0 mean, 1 mean_sq, 2 rstd, 3 inv (each C floats).
__device__ __forceinline__ void finalize_channel(int64_t c, int64_t channels, float mean, float mean_sq,
                                                 float* __restrict__ stats, const float* __restrict__ weight,
                                                 float* __restrict__ running_mean, float* __restrict__ running_var,
                                                 float eps, float keep, float momentum, float correction, bool update) {
  const float var = __fsub_rn(mean_sq, __fmul_rn(mean, mean));
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  stats[c] = mean;
  stats[channels + c] = mean_sq;
  stats[2 * channels + c] = rstd;
  stats[3 * channels + c] = __fmul_rn(rstd, weight[c]);
  if (update) {
    running_mean[c] = __fadd_rn(__fmul_rn(keep, running_mean[c]), __fmul_rn(momentum, mean));
    running_var[c] = __fadd_rn(__fmul_rn(keep, running_var[c]), __fmul_rn(__fmul_rn(momentum, var), correction));
  }
}

// coef rows: 0 a, 1 b of dx = g' * inv + a + b * (x - mean).
__device__ __forceinline__ void grad_coefficients(int64_t c, int64_t channels, float s1, float s2, float s1_mean,
                                                  float s2_mean, const float* __restrict__ stats,
                                                  const float* __restrict__ weight, float* __restrict__ dweight,
                                                  float* __restrict__ dbias, float* __restrict__ coef, float count) {
  const float rstd = stats[2 * channels + c], inv = stats[3 * channels + c];
  dbias[c] = s1;
  dweight[c] = __fmul_rn(s2, rstd);
  const float rstd3 = __fmul_rn(__fmul_rn(rstd, rstd), rstd);
  const float dvar = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, weight[c]), rstd3), s2_mean);
  coef[c] = __fdiv_rn(-__fmul_rn(inv, s1_mean), count);
  coef[channels + c] = __fdiv_rn(__fmul_rn(2.0f, dvar), count);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial_kernel(const float* __restrict__ x, float2* __restrict__ partial, int64_t channels, uint32_t hwv,
                     uint32_t units, uint32_t per_chunk) {
  const int64_t c = blockIdx.y;
  const uint32_t start = blockIdx.x * per_chunk;
  const uint32_t end = min(units, start + per_chunk);
  float s = 0.0f, q = 0.0f;
  for (uint32_t u = start + threadIdx.x; u < end; u += kThreads) {
    float r[V];
    load<V>(x + channel_offset(u, hwv, c, channels) * V, r);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s += r[k];
      q += r[k] * r[k];
    }
  }
  const float2 t = block_sum2(s, q);
  if (threadIdx.x == 0) {
    partial[c * gridDim.x + blockIdx.x] = t;
  }
}

template <bool FINALIZE>
__global__ void __launch_bounds__(kThreads)
bn_stats_sum_kernel(const float2* __restrict__ partial, float* __restrict__ stats, const float* __restrict__ weight,
                 float* __restrict__ running_mean, float* __restrict__ running_var, int64_t channels, int64_t chunks,
                 float count, float eps, float keep, float momentum, float correction, bool update) {
  const int64_t c = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= channels) {
    return;
  }
  const float2 t = warp_sum_partials(partial + c * chunks, chunks);
  if ((threadIdx.x & 31) != 0) {
    return;
  }
  const float mean = __fdiv_rn(t.x, count), mean_sq = __fdiv_rn(t.y, count);
  if (FINALIZE) {
    finalize_channel(c, channels, mean, mean_sq, stats, weight, running_mean, running_var, eps, keep, momentum,
                     correction, update);
  } else {
    stats[c] = mean;
    stats[channels + c] = mean_sq;
  }
}

__global__ void __launch_bounds__(kThreads)
bn_finalize_kernel(const float* __restrict__ mean, const float* __restrict__ mean_sq, float* __restrict__ stats,
                const float* __restrict__ weight, float* __restrict__ running_mean, float* __restrict__ running_var,
                int64_t channels, float eps, float keep, float momentum, float correction, bool update) {
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c < channels) {
    finalize_channel(c, channels, mean[c], mean_sq[c], stats, weight, running_mean, running_var, eps, keep, momentum,
                     correction, update);
  }
}

template <int V, bool SWISH>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const float* __restrict__ x, float* __restrict__ y, const float* __restrict__ stats,
             const float* __restrict__ bias, uint32_t channels, uint32_t hwv, uint32_t units) {
  for (uint32_t u = blockIdx.x * kThreads + threadIdx.x; u < units; u += gridDim.x * kThreads) {
    const uint32_t c = (u / hwv) % channels;
    const float mean = __ldg(stats + c), inv = __ldg(stats + 3 * channels + c), b = __ldg(bias + c);
    float r[V];
    load<V>(x + (int64_t)u * V, r);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      r[k] = output<SWISH>(r[k], mean, inv, b);
    }
    store<V>(y + (int64_t)u * V, r);
  }
}

template <int V, bool SWISH>
__global__ void __launch_bounds__(kThreads)
bn_grad_partial_kernel(const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ stats,
                    const float* __restrict__ bias, float2* __restrict__ partial, int64_t channels, uint32_t hwv,
                    uint32_t units, uint32_t per_chunk) {
  const int64_t c = blockIdx.y;
  const float mean = stats[c], inv = stats[3 * channels + c], b = bias[c];
  const uint32_t start = blockIdx.x * per_chunk;
  const uint32_t end = min(units, start + per_chunk);
  float s1 = 0.0f, s2 = 0.0f;
  for (uint32_t u = start + threadIdx.x; u < end; u += kThreads) {
    const int64_t at = channel_offset(u, hwv, c, channels) * V;
    float rx[V], rg[V];
    load<V>(x + at, rx);
    load<V>(g + at, rg);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float xc;
      const float gp = grad_in<SWISH>(rx[k], rg[k], mean, inv, b, xc);
      s1 += gp;
      s2 += gp * xc;
    }
  }
  const float2 t = block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    partial[c * gridDim.x + blockIdx.x] = t;
  }
}

// sums rows: 0 S1, 1 S2 of the rank's elements.
template <bool FINALIZE>
__global__ void __launch_bounds__(kThreads)
bn_grad_sum_kernel(const float2* __restrict__ partial, float* __restrict__ sums, const float* __restrict__ stats,
                const float* __restrict__ weight, float* __restrict__ dweight, float* __restrict__ dbias,
                float* __restrict__ coef, int64_t channels, int64_t chunks, float count) {
  const int64_t c = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= channels) {
    return;
  }
  const float2 t = warp_sum_partials(partial + c * chunks, chunks);
  if ((threadIdx.x & 31) != 0) {
    return;
  }
  sums[c] = t.x;
  sums[channels + c] = t.y;
  if (FINALIZE) {
    grad_coefficients(c, channels, t.x, t.y, t.x, t.y, stats, weight, dweight, dbias, coef, count);
  }
}

__global__ void __launch_bounds__(kThreads)
bn_grad_coef_kernel(const float* __restrict__ sums, const float* __restrict__ mean_sums, const float* __restrict__ stats,
                 const float* __restrict__ weight, float* __restrict__ dweight, float* __restrict__ dbias,
                 float* __restrict__ coef, int64_t channels, float count) {
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c < channels) {
    grad_coefficients(c, channels, sums[c], sums[channels + c], mean_sums[c], mean_sums[channels + c], stats, weight,
                      dweight, dbias, coef, count);
  }
}

template <int V, bool SWISH>
__global__ void __launch_bounds__(kThreads)
bn_grad_apply_kernel(const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ dx,
                  const float* __restrict__ stats, const float* __restrict__ bias, const float* __restrict__ coef,
                  uint32_t channels, uint32_t hwv, uint32_t units) {
  for (uint32_t u = blockIdx.x * kThreads + threadIdx.x; u < units; u += gridDim.x * kThreads) {
    const uint32_t c = (u / hwv) % channels;
    const float mean = __ldg(stats + c), inv = __ldg(stats + 3 * channels + c), b = __ldg(bias + c);
    const float a = __ldg(coef + c), slope = __ldg(coef + channels + c);
    float rx[V], rg[V];
    load<V>(x + (int64_t)u * V, rx);
    load<V>(g + (int64_t)u * V, rg);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float xc;
      const float gp = grad_in<SWISH>(rx[k], rg[k], mean, inv, b, xc);
      rx[k] = __fadd_rn(__fadd_rn(__fmul_rn(gp, inv), a), __fmul_rn(slope, xc));
    }
    store<V>(dx + (int64_t)u * V, rx);
  }
}

// An elementwise pass's grid: one unit a thread, at most 16 blocks an SM's worth.
inline unsigned elementwise_blocks(uint32_t units) {
  const uint32_t blocks = (units + kThreads - 1) / kThreads;
  return blocks < 132u * 16u ? (blocks > 0 ? blocks : 1u) : 132u * 16u;
}

inline unsigned channel_blocks(int64_t channels, int per_block) {
  return (unsigned)((channels + per_block - 1) / per_block);
}

}  // namespace

// Forward statistics of x (n, c, hw): partial sums into partial (c, chunks,
// 2), then mean and mean_sq into stats rows 0-1; with finalize also rstd and
// inv (rows 2-3) and, with update, the running statistics.  vec 4 or 1.
extern "C" int hegp_bn_stats(const void* x, void* partial, void* stats, const void* weight, void* running_mean,
                             void* running_var, int64_t n, int64_t c, int64_t hw, int64_t chunks, int64_t per_chunk,
                             int64_t vec, float count, float eps, float keep, float momentum, float correction,
                             int64_t finalize, int64_t update, cudaStream_t s) {
  const uint32_t hwv = (uint32_t)(hw / vec), units = (uint32_t)(n * hwv);
  const dim3 grid((unsigned)chunks, (unsigned)c);
  const float* xf = static_cast<const float*>(x);
  float2* p = static_cast<float2*>(partial);
  if (vec == 4) {
    bn_stats_partial_kernel<4><<<grid, kThreads, 0, s>>>(xf, p, c, hwv, units, (uint32_t)per_chunk);
  } else {
    bn_stats_partial_kernel<1><<<grid, kThreads, 0, s>>>(xf, p, c, hwv, units, (uint32_t)per_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return (int)err;
  }
  auto sum = finalize ? bn_stats_sum_kernel<true> : bn_stats_sum_kernel<false>;
  sum<<<channel_blocks(c, kWarps), kThreads, 0, s>>>(
      p, static_cast<float*>(stats), static_cast<const float*>(weight), static_cast<float*>(running_mean),
      static_cast<float*>(running_var), c, chunks, count, eps, keep, momentum, correction, update != 0);
  return (int)cudaGetLastError();
}

// rstd, inv and the running statistics from the mesh's mean and mean_sq;
// stats rows 0-1 take those means.
extern "C" int hegp_bn_finalize(const void* mean, const void* mean_sq, void* stats, const void* weight,
                                void* running_mean, void* running_var, int64_t c, float eps, float keep,
                                float momentum, float correction, int64_t update, cudaStream_t s) {
  bn_finalize_kernel<<<channel_blocks(c, kThreads), kThreads, 0, s>>>(
      static_cast<const float*>(mean), static_cast<const float*>(mean_sq), static_cast<float*>(stats),
      static_cast<const float*>(weight), static_cast<float*>(running_mean), static_cast<float*>(running_var), c, eps,
      keep, momentum, correction, update != 0);
  return (int)cudaGetLastError();
}

// y = (x - mean) * inv + bias [then y * sigmoid(y)].
extern "C" int hegp_bn_apply(const void* x, void* y, const void* stats, const void* bias, int64_t n, int64_t c,
                             int64_t hw, int64_t vec, int64_t swish, cudaStream_t s) {
  const uint32_t hwv = (uint32_t)(hw / vec), units = (uint32_t)(n * c * hwv);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  const float* st = static_cast<const float*>(stats);
  const float* b = static_cast<const float*>(bias);
  const unsigned blocks = elementwise_blocks(units);
  if (vec == 4) {
    (swish ? bn_apply_kernel<4, true> : bn_apply_kernel<4, false>)<<<blocks, kThreads, 0, s>>>(xf, yf, st, b, (uint32_t)c,
                                                                                       hwv, units);
  } else {
    (swish ? bn_apply_kernel<1, true> : bn_apply_kernel<1, false>)<<<blocks, kThreads, 0, s>>>(xf, yf, st, b, (uint32_t)c,
                                                                                       hwv, units);
  }
  return (int)cudaGetLastError();
}

// Backward sums S1, S2 of the rank's elements into sums (2, c); with
// finalize also dweight, dbias and coef (2, c) from them.
extern "C" int hegp_bn_grad_sums(const void* x, const void* g, const void* stats, const void* bias,
                                 const void* weight, void* partial, void* sums, void* dweight, void* dbias, void* coef,
                                 int64_t n, int64_t c, int64_t hw, int64_t chunks, int64_t per_chunk, int64_t vec,
                                 int64_t swish, float count, int64_t finalize, cudaStream_t s) {
  const uint32_t hwv = (uint32_t)(hw / vec), units = (uint32_t)(n * hwv);
  const dim3 grid((unsigned)chunks, (unsigned)c);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  const float* st = static_cast<const float*>(stats);
  const float* b = static_cast<const float*>(bias);
  float2* p = static_cast<float2*>(partial);
  if (vec == 4) {
    (swish ? bn_grad_partial_kernel<4, true> : bn_grad_partial_kernel<4, false>)<<<grid, kThreads, 0, s>>>(
        xf, gf, st, b, p, c, hwv, units, (uint32_t)per_chunk);
  } else {
    (swish ? bn_grad_partial_kernel<1, true> : bn_grad_partial_kernel<1, false>)<<<grid, kThreads, 0, s>>>(
        xf, gf, st, b, p, c, hwv, units, (uint32_t)per_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return (int)err;
  }
  auto sum = finalize ? bn_grad_sum_kernel<true> : bn_grad_sum_kernel<false>;
  sum<<<channel_blocks(c, kWarps), kThreads, 0, s>>>(
      p, static_cast<float*>(sums), st, static_cast<const float*>(weight), static_cast<float*>(dweight),
      static_cast<float*>(dbias), static_cast<float*>(coef), c, chunks, count);
  return (int)cudaGetLastError();
}

// dweight, dbias and coef from the rank's sums and their mean over the mesh.
extern "C" int hegp_bn_grad_coef(const void* sums, const void* mean_sums, const void* stats, const void* weight,
                                 void* dweight, void* dbias, void* coef, int64_t c, float count, cudaStream_t s) {
  bn_grad_coef_kernel<<<channel_blocks(c, kThreads), kThreads, 0, s>>>(
      static_cast<const float*>(sums), static_cast<const float*>(mean_sums), static_cast<const float*>(stats),
      static_cast<const float*>(weight), static_cast<float*>(dweight), static_cast<float*>(dbias),
      static_cast<float*>(coef), c, count);
  return (int)cudaGetLastError();
}

// dx = g' * inv + a + b * (x - mean).
extern "C" int hegp_bn_grad_apply(const void* x, const void* g, void* dx, const void* stats, const void* bias,
                                  const void* coef, int64_t n, int64_t c, int64_t hw, int64_t vec, int64_t swish,
                                  cudaStream_t s) {
  const uint32_t hwv = (uint32_t)(hw / vec), units = (uint32_t)(n * c * hwv);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  float* d = static_cast<float*>(dx);
  const float* st = static_cast<const float*>(stats);
  const float* b = static_cast<const float*>(bias);
  const float* cf = static_cast<const float*>(coef);
  const unsigned blocks = elementwise_blocks(units);
  if (vec == 4) {
    (swish ? bn_grad_apply_kernel<4, true> : bn_grad_apply_kernel<4, false>)<<<blocks, kThreads, 0, s>>>(
        xf, gf, d, st, b, cf, (uint32_t)c, hwv, units);
  } else {
    (swish ? bn_grad_apply_kernel<1, true> : bn_grad_apply_kernel<1, false>)<<<blocks, kThreads, 0, s>>>(
        xf, gf, d, st, b, cf, (uint32_t)c, hwv, units);
  }
  return (int)cudaGetLastError();
}
