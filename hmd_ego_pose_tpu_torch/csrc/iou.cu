// Anchor / ground-truth IoU of training target assignment:
// out[b, n, k] = IoU(anchors[b, n], gt[b, k]) for B images of N anchors and
// K ground-truth boxes each, boxes (x1, y1, x2, y2) float32; 0 where the
// union is not positive.  The anchors are either one (N, 4) set shared by
// the batch (anchor_batch_stride 0) or a (B, N, 4) tensor.
//
// Replaces the TPU kernel hmd_ego_pose_tpu/ops/pallas_kernels.py
// (_iou_kernel / iou_matrix_pallas), which the JAX train step vmaps over the
// images of a batch inside target assignment (ops/target_assign.py).  The
// Pallas kernel pads N to its 256-row block and K to 128 lanes because TPU
// blocks are fixed; this kernel takes every shape as it is: one thread per
// (b, n) anchor row, the ragged last block masked.
//
// Bound: bytes.  Each pair costs ~17 float32 operations against 16 bytes of
// anchor per row and 4 bytes of output per pair; at the train step's
// B=16, N=12,276, K=1 that is 3.9 MB (~1.2 us at 3.35 TB/s) against 3.3e6
// operations (~0.05 us).  A launch at that size is a few microseconds of
// fixed cost; the design does not try to beat that.
//
// Design: grid (ceil(N / 256), min(B, 65535)), 256 threads; a block stages
// its image's K boxes and their areas through shared memory in chunks of
// 256 boxes (5 KB), read as one coalesced run of floats; each thread keeps
// its anchor in registers and writes its row's K outputs.  The arithmetic is
// iou.cuh's, shared with target_assign.cu: bit-equal to the plain version
// ops/iou.py::iou_matrix_reference.
//
// Interface: plain C (no PyTorch headers), loaded with ctypes.  The launcher
// takes device pointers and the caller's stream, allocates nothing, does not
// synchronise and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "iou.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // ground-truth boxes staged per pass

__global__ void iou_kernel(const float* __restrict__ anchors, const float* __restrict__ gt,
                           float* __restrict__ out, int64_t batch, int64_t n, int64_t k,
                           int64_t anchor_batch_stride) {
  __shared__ float staged[kChunk * 5];  // x1, y1, x2, y2, area of each box
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;
  for (int64_t b = blockIdx.y; b < batch; b += gridDim.y) {
    float ax1 = 0.f, ay1 = 0.f, ax2 = 0.f, ay2 = 0.f;
    if (active) {
      const float* a = anchors + b * anchor_batch_stride + i * 4;
      ax1 = a[0];
      ay1 = a[1];
      ax2 = a[2];
      ay2 = a[3];
    }
    const float area_a = hegp::box_area(ax1, ay1, ax2, ay2);
    const float* g = gt + b * k * 4;
    float* row = out + (b * n + i) * k;
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
        staged[5 * j + 4] = hegp::box_area(bx1, by1, bx2, by2);
      }
      __syncthreads();
      if (active) {
        for (int j = 0; j < m; ++j) {
          const float* s = staged + 5 * j;
          row[start + j] = hegp::iou(ax1, ay1, ax2, ay2, area_a, s[0], s[1], s[2], s[3], s[4]);
        }
      }
    }
  }
}

}  // namespace

extern "C" int hegp_iou(const void* anchors, const void* gt, void* out, int64_t batch, int64_t n,
                        int64_t k, int64_t anchor_batch_stride, void* stream) {
  if (batch <= 0 || n <= 0 || k <= 0 || anchor_batch_stride < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks_x = (n + kThreads - 1) / kThreads;
  if (blocks_x > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned int blocks_y = (unsigned int)(batch < 65535 ? batch : 65535);
  dim3 grid((unsigned int)blocks_x, blocks_y);
  iou_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)anchors, (const float*)gt, (float*)out, batch, n, k, anchor_batch_stride);
  return (int)cudaGetLastError();
}
