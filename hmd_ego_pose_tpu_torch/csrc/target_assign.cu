// Anchor target assignment of a training batch, fused around the anchor IoU:
// for B images of K padded ground-truth rows each and N anchors shared by
// the batch, the five per-anchor targets of ops/target_assign.py
// (labels (B, N, C) one-hot, regression (B, N, 4), transformation (B, N, DT),
// coords_3d (B, N, DC), state (B, N)), all float32.
//
// Replaces the TPU kernel hmd_ego_pose_tpu/ops/pallas_kernels.py
// (_iou_kernel / iou_matrix_pallas) on the train path, together with the XLA
// code around it in hmd_ego_pose_tpu/ops/target_assign.py (argmaxes,
// thresholds, the forced-positive scatter, bbox_transform, the gathers),
// which the JAX train step vmaps over the images of a batch.  The IoU is
// computed here and never stored: the (B, N, K) matrix the Pallas kernel
// writes out is gone.
//
// Bound: bytes.  The five outputs are (C + 4 + DT + DC + 1) floats per
// anchor; at the train step's B=16, N=12,276, K=1, C=1, DT=8, DC=63 that is
// 60.5 MB of writes (~18 us at 3.35 TB/s) against ~0.2 MB of reads and
// ~7e6 operations.
//
// Design: two launches, both deterministic, no atomics.
//  A. best_anchor_kernel, grid (B*K), 1024 threads: for one ground-truth row,
//     the argmax over the N anchors of its padded IoU column (first index on
//     ties, as jnp.argmax and torch.argmax; a padded row's column is all -1,
//     so its best anchor is anchor 0 and the scan is skipped).  Each thread
//     scans a strided share of the anchors, then a warp-shuffle and a
//     shared-memory reduction keep (larger value, then smaller index).
//     Writes (B, K) int32 indices into scratch the wrapper allocates.
//  B. assign_kernel, grid (ceil(N / 256), B), 256 threads, one anchor each:
//     the image's K boxes, areas, valid flags and best anchors are staged in
//     shared memory in chunks of 256 rows; each thread computes the IoU to
//     every row (padding at -1), the running max and argmax over K (first on
//     ties), whether it is forced positive (its index equals best[b, k] for
//     the LAST such k and that row is valid: XLA's last-row-wins scatter),
//     then positive / ignore / out-of-image / any_valid -> state, exactly as
//     hmd_ego_pose_tpu/ops/target_assign.py:68-94, and the regression target
//     of ops/target_assign.py::bbox_transform.  Per-anchor results go to
//     shared memory; the block then writes each output's span of its 256
//     anchors as one flat, coalesced range (neighbouring threads on
//     neighbouring floats), each element's ground-truth row read through the
//     per-anchor argmax in shared memory.  The row and column of a flat
//     element advance by constant steps per iteration, so no division runs
//     per element.  Launch bounds of 3 blocks per SM hold it to 80 registers
//     (96 at one block per SM), three waves of 768 blocks at the train shape.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py,
// scripts/time_kernel_variants.py): both launches 0.0356-0.0364 ms at the
// train shape, ~50 % of the bound; launch A alone 0.009 ms (16 blocks:
// latency, not bytes), launch B alone 0.026 ms, below torch's fill of the
// same five outputs (0.030 ms); at one block per SM 0.037-0.038 ms.
//
// Numerics: every output is bit-equal to the plain version
// ops/target_assign.py::assign_targets_batch_reference on the card.  The IoU
// is iou.cuh's (_rn intrinsics in iou_matrix_reference's
// order, so nvcc contracts nothing into an FMA).  The IoU is never NaN (a NaN
// union fails the union > 0 test and gives 0), so plain comparisons give
// torch.argmax / torch.amax.  bbox_transform: wa / 2.0 is an exact halving
// (multiply by 0.5), eps is float32(1e-7), the divisions are __fdiv_rn and
// the log is logf, the libdevice function PyTorch's CUDA log calls.  The
// thresholds and the image size compare in float32, as PyTorch compares a
// float32 tensor with a Python scalar.
//
// Interface: plain C (no PyTorch headers), loaded with ctypes.  The launcher
// takes device pointers and the caller's stream, allocates nothing, does not
// synchronise and returns cudaGetLastError() of the launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "iou.cuh"

namespace {

// The swept design constants, overridden only by the variants that
// scripts/time_kernel_variants.py builds (-D); the port builds the defaults.
#ifndef HEGP_TARGET_ASSIGN_MIN_BLOCKS
#define HEGP_TARGET_ASSIGN_MIN_BLOCKS 3  // assign_kernel's launch bounds: blocks per SM
#endif
#ifndef HEGP_TARGET_ASSIGN_LAUNCHES
#define HEGP_TARGET_ASSIGN_LAUNCHES 3  // bit 0 launch A, bit 1 launch B (1 or 2 times one alone)
#endif

constexpr int kMinBlocks = HEGP_TARGET_ASSIGN_MIN_BLOCKS;
constexpr int kLaunches = HEGP_TARGET_ASSIGN_LAUNCHES;
constexpr int kBestThreads = 1024;
constexpr int kThreads = 256;  // anchors per block of the assign kernel
constexpr int kChunk = 256;    // ground-truth rows staged per pass
constexpr float kEps = 1e-7f;  // bbox_transform's eps, as float32

using hegp::box_area;
using hegp::iou;

// (value, index) a beats b: larger value, then smaller index
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__global__ void best_anchor_kernel(const float* __restrict__ anchors, const float* __restrict__ gt,
                                   const uint8_t* __restrict__ valid, int32_t* __restrict__ best,
                                   int64_t n, int64_t rows) {
  __shared__ float warp_v[kBestThreads / 32];
  __shared__ int warp_i[kBestThreads / 32];
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    if (!valid[row]) {  // padded: an all -1 column, whose argmax is anchor 0
      if (threadIdx.x == 0) best[row] = 0;
      continue;
    }
    const float bx1 = gt[row * 4], by1 = gt[row * 4 + 1], bx2 = gt[row * 4 + 2], by2 = gt[row * 4 + 3];
    const float area_b = box_area(bx1, by1, bx2, by2);
    float v = -INFINITY;
    int idx = 0x7fffffff;
    for (int64_t i = threadIdx.x; i < n; i += kBestThreads) {  // increasing i: '>' keeps the first
      const float* a = anchors + i * 4;
      const float o = iou(a[0], a[1], a[2], a[3], box_area(a[0], a[1], a[2], a[3]), bx1, by1, bx2, by2, area_b);
      if (o > v) {
        v = o;
        idx = (int)i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, idx, off);
      if (beats(ov, oi, v, idx)) {
        v = ov;
        idx = oi;
      }
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
      warp_v[warp] = v;
      warp_i[warp] = idx;
    }
    __syncthreads();
    if (warp == 0) {
      v = warp_v[lane];
      idx = warp_i[lane];
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, v, off);
        const int oi = __shfl_down_sync(0xffffffffu, idx, off);
        if (beats(ov, oi, v, idx)) {
          v = ov;
          idx = oi;
        }
      }
      if (lane == 0) best[row] = idx;
    }
    __syncthreads();  // warp_v / warp_i are read before the next row writes them
  }
}

// Writes rows [0, count) of width d of a block's span, flat: element e of the
// span is row e / d, column e % d; each thread walks its elements with the
// row and column advanced by constant steps.
template <typename F>
__device__ __forceinline__ void write_span(float* __restrict__ out, int count, int d, F value) {
  const int total = count * d;
  const int step_rows = kThreads / d, step_cols = kThreads % d;
  int row = threadIdx.x / d, col = threadIdx.x % d;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    out[e] = value(row, col);
    row += step_rows;
    col += step_cols;
    if (col >= d) {
      col -= d;
      ++row;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) assign_kernel(const float* __restrict__ anchors, const float* __restrict__ gt,
                              const int32_t* __restrict__ labels, const float* __restrict__ trans,
                              const float* __restrict__ coords, const uint8_t* __restrict__ valid,
                              const int32_t* __restrict__ best, float* __restrict__ out_labels,
                              float* __restrict__ out_regression, float* __restrict__ out_trans,
                              float* __restrict__ out_coords, float* __restrict__ out_state,
                              int64_t batch, int64_t n, int64_t k, int64_t num_classes, int64_t dt,
                              int64_t dc, float image_size, float positive_overlap,
                              float negative_overlap) {
  __shared__ float staged[kChunk * 5];  // x1, y1, x2, y2, area of each row
  __shared__ int staged_best[kChunk];
  __shared__ uint8_t staged_valid[kChunk];
  __shared__ int assigned[kThreads];    // per anchor: its best-overlap ground-truth row
  __shared__ int label[kThreads];       // per anchor: that row's label if the anchor is positive, else -1
  __shared__ float regression[kThreads * 4];
  __shared__ int any_valid;

  const int64_t first = (int64_t)blockIdx.x * kThreads;
  const int count = (int)((n - first) < kThreads ? (n - first) : kThreads);
  const int64_t i = first + threadIdx.x;
  const bool active = threadIdx.x < count;
  float ax1 = 0.f, ay1 = 0.f, ax2 = 0.f, ay2 = 0.f;
  if (active) {
    const float* a = anchors + i * 4;
    ax1 = a[0];
    ay1 = a[1];
    ax2 = a[2];
    ay2 = a[3];
  }
  const float area_a = box_area(ax1, ay1, ax2, ay2);
  // (anchors[:, 0] + anchors[:, 2]) / 2: an exact halving
  const float cx = __fmul_rn(__fadd_rn(ax1, ax2), 0.5f);
  const float cy = __fmul_rn(__fadd_rn(ay1, ay2), 0.5f);
  const bool outside = cx >= image_size || cy >= image_size;

  for (int64_t b = blockIdx.y; b < batch; b += gridDim.y) {
    const float* g = gt + b * k * 4;
    if (threadIdx.x == 0) any_valid = 0;
    float max_overlap = -INFINITY;
    int argmax = 0;
    int forced_row = -1;  // the last row whose best anchor is this one
    for (int64_t start = 0; start < k; start += kChunk) {
      const int m = (int)((k - start) < kChunk ? (k - start) : kChunk);
      __syncthreads();  // the previous chunk (or image) is no longer read
      for (int j = threadIdx.x; j < m; j += kThreads) {
        const float* box = g + (start + j) * 4;
        const float bx1 = box[0], by1 = box[1], bx2 = box[2], by2 = box[3];
        staged[5 * j] = bx1;
        staged[5 * j + 1] = by1;
        staged[5 * j + 2] = bx2;
        staged[5 * j + 3] = by2;
        staged[5 * j + 4] = box_area(bx1, by1, bx2, by2);
        staged_best[j] = best[b * k + start + j];
        staged_valid[j] = valid[b * k + start + j];
        if (staged_valid[j]) any_valid = 1;
      }
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const float* s = staged + 5 * j;
        const float o = staged_valid[j] ? iou(ax1, ay1, ax2, ay2, area_a, s[0], s[1], s[2], s[3], s[4]) : -1.f;
        if (o > max_overlap) {  // increasing j: '>' keeps the first on ties
          max_overlap = o;
          argmax = (int)(start + j);
        }
        if (staged_best[j] == i) forced_row = (int)(start + j);
      }
    }
    // forced_row < k: its valid flag is read from global memory (its chunk may be gone)
    const bool forced = forced_row >= 0 && valid[b * k + forced_row];
    const bool positive = max_overlap >= positive_overlap || forced;
    const bool ignore = max_overlap > negative_overlap && !positive;
    float state;
    if (!any_valid) {
      state = outside ? -1.f : 0.f;
    } else {
      state = outside || ignore ? -1.f : (positive ? 1.f : 0.f);
    }

    const int t = threadIdx.x;
    if (active) {
      assigned[t] = argmax;
      label[t] = state == 1.f ? labels[b * k + argmax] : -1;
      // bbox_transform(anchor, gt[argmax]) in the plain version's order
      const float* box = g + (int64_t)argmax * 4;
      float wa = __fsub_rn(ax2, ax1);
      float ha = __fsub_rn(ay2, ay1);
      const float cxa = __fadd_rn(ax1, __fmul_rn(wa, 0.5f));
      const float cya = __fadd_rn(ay1, __fmul_rn(ha, 0.5f));
      float w = __fsub_rn(box[2], box[0]);
      float h = __fsub_rn(box[3], box[1]);
      const float gcx = __fadd_rn(box[0], __fmul_rn(w, 0.5f));
      const float gcy = __fadd_rn(box[1], __fmul_rn(h, 0.5f));
      ha = __fadd_rn(ha, kEps);
      wa = __fadd_rn(wa, kEps);
      h = __fadd_rn(h, kEps);
      w = __fadd_rn(w, kEps);
      regression[4 * t] = __fdiv_rn(__fsub_rn(gcy, cya), ha);
      regression[4 * t + 1] = __fdiv_rn(__fsub_rn(gcx, cxa), wa);
      regression[4 * t + 2] = logf(__fdiv_rn(h, ha));
      regression[4 * t + 3] = logf(__fdiv_rn(w, wa));
      out_state[b * n + i] = state;
    }
    __syncthreads();

    const int64_t row0 = b * n + first;  // the block's first output row
    write_span(out_labels + row0 * num_classes, count, (int)num_classes,
               [&](int r, int c) { return label[r] == c ? 1.f : 0.f; });
    write_span(out_regression + row0 * 4, count, 4, [&](int r, int c) { return regression[4 * r + c]; });
    const float* tb = trans + b * k * dt;
    write_span(out_trans + row0 * dt, count, (int)dt,
               [&](int r, int c) { return tb[(int64_t)assigned[r] * dt + c]; });
    const float* cb = coords + b * k * dc;
    write_span(out_coords + row0 * dc, count, (int)dc,
               [&](int r, int c) { return cb[(int64_t)assigned[r] * dc + c]; });
  }
}

}  // namespace

// best: (B, K) int32 scratch.  Shapes: anchors (N, 4); gt (B, K, 4); labels
// (B, K) int32; trans (B, K, DT); coords (B, K, DC); valid (B, K) bool (one
// byte); outputs (B, N, C), (B, N, 4), (B, N, DT), (B, N, DC), (B, N).
extern "C" int hegp_target_assign(const void* anchors, const void* gt, const void* labels,
                                  const void* trans, const void* coords, const void* valid, void* best,
                                  void* out_labels, void* out_regression, void* out_trans,
                                  void* out_coords, void* out_state, int64_t batch, int64_t n,
                                  int64_t k, int64_t num_classes, int64_t dt, int64_t dc,
                                  float image_size, float positive_overlap, float negative_overlap,
                                  void* stream) {
  if (batch <= 0 || n <= 0 || k <= 0 || num_classes <= 0 || dt <= 0 || dc <= 0 || n > 0x7fffffff ||
      k > 0x7fffffff || kThreads * (num_classes > dc ? num_classes : dc) > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t rows = batch * k;
  const unsigned int best_blocks = (unsigned int)(rows < 65535 ? rows : 65535);
  if (kLaunches & 1) {
    best_anchor_kernel<<<best_blocks, kBestThreads, 0, s>>>(
        (const float*)anchors, (const float*)gt, (const uint8_t*)valid, (int32_t*)best, n, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
      return (int)err;
    }
  }
  if (!(kLaunches & 2)) {
    return (int)cudaSuccess;
  }
  const int64_t blocks_x = (n + kThreads - 1) / kThreads;
  const unsigned int blocks_y = (unsigned int)(batch < 65535 ? batch : 65535);
  dim3 grid((unsigned int)blocks_x, blocks_y);
  assign_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)anchors, (const float*)gt, (const int32_t*)labels, (const float*)trans,
      (const float*)coords, (const uint8_t*)valid, (const int32_t*)best, (float*)out_labels,
      (float*)out_regression, (float*)out_trans, (float*)out_coords, (float*)out_state, batch, n, k,
      num_classes, dt, dc, image_size, positive_overlap, negative_overlap);
  return (int)cudaGetLastError();
}
