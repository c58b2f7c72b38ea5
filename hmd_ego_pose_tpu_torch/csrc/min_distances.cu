// ADD-S min distances: out[t, i] = min over j of |gt[t, i] - pred[t, j]|,
// for T pose pairs of (P, 3) GT points and (Q, 3) predicted points.
//
// Replaces the TPU kernel hmd_ego_pose_tpu/ops/pallas_kernels.py
// (_min_dist_kernel / min_distances_pallas), which the JAX evaluator vmaps
// over every true-positive pose pair of a class (eval/metrics.py,
// _add_s_device_fn).  The Pallas kernel pads P to 512 and Q to 128 and masks
// the padded predictions to +inf; this kernel needs no padding: it masks the
// ragged GT slice and walks Q in chunks of any length.
//
// Bound: operations.  Each (i, j) pair costs 3 sub, 3 mul, 2 add and 1 min,
// so T*P*Q*9 float32 operations against T*(P+Q)*3*4 + T*P*4 bytes; at the
// evaluation's T=200, P=Q=600 that is 6.5e8 operations (~9.7 us at the
// card's 67 TFLOP/s without tensor cores) against 3.4 MB (~1.0 us).  The
// 67 TFLOP/s counts an FMA as two operations; the bit-equal arithmetic has
// no FMA, so its 9 instructions a pair run at 128 lanes per clock per SM:
// ~19-22 us at 132 SMs and 1.75-1.98 GHz is the ceiling of this kernel.
//
// Design (bound by instruction throughput, so the work is in what surrounds
// the 9 instructions):
//  * register blocking: each thread holds R = kPoints = 4 ground-truth points
//    in registers; one shared load of a predicted point feeds R points;
//  * staging: the pair's predicted points go to shared memory as float4
//    (x, y, z, pad), so the shared load is one LDS.128; up to 2048 points
//    (32 KB) in one pass with one __syncthreads, longer Q in chunks of 2048;
//  * NaN: carried through the min by min.NaN.f32 (PTX, sm_80+), which drops
//    the per-pair compare and or; a NaN distance still makes the row NaN, as
//    torch.amin does;
//  * grid: a block is 4 warps over one slice of at most 32 * R ground-truth
//    points of one pose pair (lane l holds points l, l + 32, ...), and its
//    warps split the predicted points four ways; the four partial minima of a
//    point meet in shared memory (min is exact, so the order cannot change a
//    bit).  The slice is sized at launch: ceil(P / (32 R)) slices per pair,
//    P spread evenly over them, so the ragged last slice wastes little.  At
//    the evaluation's T=200, P=600 and R=4 that is 5 slices of 120 points,
//    1000 blocks of 4 warps (7-8 per SM, in one wave) with 30 of 32 lanes
//    busy.
// Variants measured at the evaluation's shape on an H100 80GB HBM3 at 700 W
// (scripts/time_kernel_variants.py; the launch alone): R = 2 / 4 / 8:
// 0.031 / 0.029 / 0.035 ms (R = 8 leaves 3
// slices of 200 points, 25 of 32 lanes busy); 2 / 4 / 8 warps a block:
// 0.031 / 0.029 / 0.029 ms; the inner loop unrolled 1 / 4 / 8 times: 0.032 /
// 0.029 / 0.029 ms (8 is kept, 2-3 % ahead at ten times the pairs).  Ten
// times the pairs take 0.248 ms, so ~4 us of a launch is fixed cost and the
// steady rate is ~11.8 instruction slots a pair against the 9.4 counted above
// (9 FP32, a quarter of the LDS.128, the loop).
// The arithmetic is written with the _rn intrinsics, in the plain PyTorch
// version's order (dx*dx + dy*dy, then + dz*dz), so nvcc cannot contract it
// into FMAs and the result is bit-equal to
// ops/distances.py::min_distances_reference.  Direct differences are kept:
// the |g|^2 + |p|^2 - 2 g.p expansion loses about a millimetre at these
// coordinates.
//
// Interface: plain C (no PyTorch headers), loaded with ctypes.  The launcher
// takes device pointers and the caller's stream, allocates nothing, does not
// synchronise and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The swept design constants, overridden only by the variants that
// scripts/time_kernel_variants.py builds (-D); the port builds the defaults.
#ifndef HEGP_MIN_DIST_WARPS
#define HEGP_MIN_DIST_WARPS 4
#endif
#ifndef HEGP_MIN_DIST_POINTS
#define HEGP_MIN_DIST_POINTS 4
#endif
#ifndef HEGP_MIN_DIST_UNROLL
#define HEGP_MIN_DIST_UNROLL 8
#endif

constexpr int kWarps = HEGP_MIN_DIST_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kPoints = HEGP_MIN_DIST_POINTS;  // R: ground-truth points a thread holds
constexpr int kUnroll = HEGP_MIN_DIST_UNROLL;  // of the loop over staged predicted points
constexpr int kChunk = 2048;  // predicted points staged per pass (32 KB as float4)

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// dynamic shared memory: `cap` staged points as float4, then kWarps * 32 * R partial minima
__global__ void __launch_bounds__(kThreads) min_distances_kernel(
    const float* __restrict__ gt, const float* __restrict__ pred, float* __restrict__ out,
    int64_t num_pairs, int64_t p, int64_t q, int slice, int cap) {
  constexpr int R = kPoints;
  extern __shared__ float4 staged[];
  float* partial = reinterpret_cast<float*>(staged + cap);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t first = (int64_t)blockIdx.x * slice;
  const int count = (int)((p - first) < slice ? (p - first) : slice);
  for (int64_t t = blockIdx.y; t < num_pairs; t += gridDim.y) {
    float gx[R], gy[R], gz[R], best[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = lane + 32 * r;
      const float* g = gt + (t * p + first + (s < count ? s : 0)) * 3;
      gx[r] = g[0];
      gy[r] = g[1];
      gz[r] = g[2];
      best[r] = INFINITY;
    }
    const float* pr = pred + t * q * 3;
    for (int64_t start = 0; start < q; start += cap) {
      const int m = (int)((q - start) < cap ? (q - start) : cap);
      __syncthreads();  // the previous chunk (or pair) is no longer read
      for (int j = threadIdx.x; j < m; j += kThreads) {
        const float* x = pr + (start + j) * 3;
        staged[j] = make_float4(x[0], x[1], x[2], 0.f);
      }
      __syncthreads();
      const int lo = m * warp / kWarps, hi = m * (warp + 1) / kWarps;
#pragma unroll (kUnroll)
      for (int j = lo; j < hi; ++j) {
        const float4 v = staged[j];  // the same address across the warp: a broadcast
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float dx = __fsub_rn(gx[r], v.x);
          const float dy = __fsub_rn(gy[r], v.y);
          const float dz = __fsub_rn(gz[r], v.z);
          const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
          best[r] = min_nan(best[r], d2);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      partial[warp * 32 * R + lane + 32 * r] = best[r];
    }
    __syncthreads();
    for (int s = threadIdx.x; s < count; s += kThreads) {
      float v = partial[s];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        v = min_nan(v, partial[w * 32 * R + s]);
      }
      out[t * p + first + s] = __fsqrt_rn(v);
    }
  }
}

}  // namespace

extern "C" int hegp_min_distances(const void* gt, const void* pred, void* out, int64_t num_pairs,
                                  int64_t p, int64_t q, void* stream) {
  if (num_pairs <= 0 || p <= 0 || q <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int R = kPoints;
  const int64_t slices = (p + 32 * R - 1) / (32 * R);  // per pair
  const int slice = (int)((p + slices - 1) / slices);  // P spread evenly over them
  const int64_t blocks_x = (p + slice - 1) / slice;
  if (blocks_x > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  const int cap = (int)(q < kChunk ? q : kChunk);
  const size_t shared = (size_t)cap * sizeof(float4) + (size_t)kWarps * 32 * R * sizeof(float);
  const unsigned int blocks_y = (unsigned int)(num_pairs < 65535 ? num_pairs : 65535);
  dim3 grid((unsigned int)blocks_x, blocks_y);
  min_distances_kernel<<<grid, kThreads, shared, (cudaStream_t)stream>>>(
      (const float*)gt, (const float*)pred, (float*)out, num_pairs, p, q, slice, cap);
  return (int)cudaGetLastError();
}
