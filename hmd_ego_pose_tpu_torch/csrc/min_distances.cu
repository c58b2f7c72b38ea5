// ADD-S min distances: out[t, i] = min over j of |gt[t, i] - pred[t, j]|,
// for T pose pairs of (P, 3) GT points and (Q, 3) predicted points.
//
// Replaces the TPU kernel hmd_ego_pose_tpu/ops/pallas_kernels.py
// (_min_dist_kernel / min_distances_pallas), which the JAX evaluator vmaps
// over every true-positive pose pair of a class (eval/metrics.py,
// _add_s_device_fn).  The Pallas kernel pads P to 512 and Q to 128 and masks
// the padded predictions to +inf; this kernel needs no padding: it masks the
// ragged GT block and walks Q in chunks of any length.
//
// Bound: operations.  Each (i, j) pair costs 3 sub, 3 mul, 2 add and 1 min,
// so T*P*Q*9 float32 operations against T*(P+Q)*3*4 + T*P*4 bytes; at the
// evaluation's T=200, P=Q=600 that is 6.5e8 operations (~9.7 us at the
// card's 67 TFLOP/s without tensor cores) against 3.4 MB (~1.0 us).
//
// Design: grid (ceil(P / 128), min(T, 65535)), 128 threads; a block handles
// 128 GT points of one pose pair (looping over pairs beyond the grid's y
// limit).  The block stages the pair's predicted points through shared
// memory in chunks of 1024 points (12 KB), read as one coalesced run of
// floats; each thread keeps its GT point in registers and runs a min over
// every staged point, all threads reading the same shared word at once (a
// broadcast).  The arithmetic is written with the _rn intrinsics, in the
// plain PyTorch version's order (dx*dx + dy*dy, then + dz*dz), so nvcc
// cannot contract it into FMAs and the result is bit-equal to
// ops/distances.py::min_distances_reference.  Direct differences are kept:
// the |g|^2 + |p|^2 - 2 g.p expansion loses about a millimetre at these
// coordinates.  A NaN distance makes the row's result NaN, as torch.amin
// does.
//
// Interface: plain C (no PyTorch headers), loaded with ctypes.  The launcher
// takes device pointers and the caller's stream, allocates nothing, does not
// synchronise and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;  // predicted points staged per pass (12 KB)

__global__ void min_distances_kernel(const float* __restrict__ gt,
                                     const float* __restrict__ pred,
                                     float* __restrict__ out,
                                     int64_t num_pairs, int64_t p, int64_t q) {
  __shared__ float staged[kChunk * 3];
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t t = blockIdx.y; t < num_pairs; t += gridDim.y) {
    const bool active = i < p;
    float gx = 0.f, gy = 0.f, gz = 0.f;
    if (active) {
      const float* g = gt + (t * p + i) * 3;
      gx = g[0];
      gy = g[1];
      gz = g[2];
    }
    const float* pr = pred + t * q * 3;
    float best = INFINITY;
    bool nan = false;
    for (int64_t start = 0; start < q; start += kChunk) {
      const int n = (int)((q - start) < kChunk ? (q - start) : kChunk);
      __syncthreads();  // the previous chunk (or pair) is no longer read
      for (int k = threadIdx.x; k < n * 3; k += kThreads) {
        staged[k] = pr[start * 3 + k];
      }
      __syncthreads();
      if (active) {
        for (int j = 0; j < n; ++j) {
          const float dx = __fsub_rn(gx, staged[3 * j]);
          const float dy = __fsub_rn(gy, staged[3 * j + 1]);
          const float dz = __fsub_rn(gz, staged[3 * j + 2]);
          const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                     __fmul_rn(dz, dz));
          nan |= d2 != d2;
          best = fminf(best, d2);
        }
      }
    }
    if (active) {
      out[t * p + i] = nan ? NAN : __fsqrt_rn(best);
    }
  }
}

}  // namespace

extern "C" int hegp_min_distances(const void* gt, const void* pred, void* out,
                                  int64_t num_pairs, int64_t p, int64_t q, void* stream) {
  if (num_pairs <= 0 || p <= 0 || q <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks_x = (p + kThreads - 1) / kThreads;
  if (blocks_x > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned int blocks_y = (unsigned int)(num_pairs < 65535 ? num_pairs : 65535);
  dim3 grid((unsigned int)blocks_x, blocks_y);
  min_distances_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)gt, (const float*)pred, (float*)out, num_pairs, p, q);
  return (int)cudaGetLastError();
}
