// Symmetric per-channel int8 quantize of a group of (R, C) float32 leaves
// in one launch: for every leaf, scale[c] = max(max_r |x[r, c]|, 1e-12) / 127
// and values[r, c] = clip(round_half_even(x[r, c] / scale[c]), -127, 127).
//
// Replaces the TPU kernel hmd_ego_pose_tpu/ops/quantization.py:39
// (quantize_pallas, kernel _quantize_kernel).  It computes what the JAX
// package's int8 save computes, quantize_np (numpy), not the Pallas kernel
// block by block: the Pallas kernel pads R to 32 and C to 128 and holds the
// whole array in VMEM, and XLA turns its "/ 127.0" into a multiply by
// float32(1/127), which gives scales one ulp off numpy's in a few percent of
// the columns.  Here both divisions are IEEE divisions (__fdiv_rn), so the
// kernel is bit-equal to quantize_np and to the plain PyTorch version
// ops/quantization.py::quantize_reference.
//
// The int8 save packs the large float32 leaves of a params tree into one
// buffer (one torch.cat), uploads the table (group_table.cuh) and launches
// this kernel once; the packed values and scales come back in one copy each.
//
// Bound: bytes.  Each value is read as 4 bytes and written as 1, with a
// handful of operations (abs, max, divide, round, clip) per value, far below
// the card's ridge point: 15.4 MB read and 3.8 MB written for the 137 leaves
// of the shipped artifact, 0.0058 ms at 3.35 TB/s.  This kernel reads x twice
// (once for the column maxima, once to quantize), 9 bytes per value where
// the bound counts 5; the whole group fits in the 50 MB L2, so the second
// read is L2 traffic.  Launched once per leaf, the kernel was bound by the
// host's time per launch (27-37 us per leaf); one launch for the group
// removes that.  Staging a tile in shared memory for the second read is left
// until a launch's time shows that the re-read costs something.
//
// Design: a block covers a tile of 32 consecutive columns of one leaf with
// 32 x 16 threads (1,736 blocks for the shipped artifact's 55,020 columns);
// it finds its leaf by a binary search over the table's first-block column.
// threadIdx.x is the column, so each warp's loads and stores are coalesced
// along the row-major C axis, and the 16 row threads stride down the rows.
// The column maxima are reduced through shared memory (max is exact, so the
// order does not matter), the scale is written by row thread 0, and the same
// block then quantizes its columns.  A block never reads or writes outside
// its leaf, so a NaN in one leaf touches no other.
//
// Numbers: __fdiv_rn for both divisions (never a multiply by a reciprocal);
// rintf rounds half to even in the default rounding mode (roundf would round
// half away from zero); the 1e-12 floor is float32's 1e-12f, as numpy 2
// gives it, so a column of zeros has scale 1e-12f/127 and values 0.
// Denormals are kept (no -ftz, no --use_fast_math).  NaN: the maxima
// propagate it as numpy's max does, so a column holding NaN gets a NaN
// scale; a quotient that is NaN is written as 0, which is what float-to-int
// conversion gives on the card (numpy and torch leave that cast unspecified).
//
// Interface: plain C (no PyTorch headers), loaded with ctypes.  The launcher
// takes device pointers and the caller's stream, allocates nothing, does not
// synchronise and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "group_table.cuh"

namespace {

constexpr int kCols = 32;  // columns per block: one warp's width
constexpr int kRows = 16;  // row threads per block

// max that keeps NaN from either side, as np.max / np.maximum do (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void __launch_bounds__(kCols * kRows)
quantize_group_kernel(const float* __restrict__ x, int8_t* __restrict__ values, float* __restrict__ scales,
                      const int64_t* __restrict__ table, int leaves) {
  __shared__ float partial[kRows][kCols];
  __shared__ float tile_scale[kCols];
  const int64_t b = blockIdx.x;
  const hegp::Leaf leaf = hegp::leaf_of_block(table, leaves, b);
  const float* xl = x + leaf.in;
  int8_t* vl = values + leaf.out;
  const int64_t rows = leaf.rows, cols = leaf.cols;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t c = (b - leaf.first) * kCols + tx;
  const bool in = c < cols;

  float m = 0.0f;
  if (in) {
    for (int64_t r = ty; r < rows; r += kRows) {
      m = max_nan(m, fabsf(xl[r * cols + c]));
    }
  }
  partial[ty][tx] = m;
  __syncthreads();
  if (ty == 0) {
    for (int i = 1; i < kRows; ++i) {
      m = max_nan(m, partial[i][tx]);
    }
    const float s = __fdiv_rn(max_nan(m, 1e-12f), 127.0f);
    tile_scale[tx] = s;
    if (in) {
      scales[leaf.scales + c] = s;
    }
  }
  __syncthreads();
  if (!in) {
    return;
  }
  const float s = tile_scale[tx];
  for (int64_t r = ty; r < rows; r += kRows) {
    const float q = rintf(__fdiv_rn(xl[r * cols + c], s));
    vl[r * cols + c] = (q == q) ? (int8_t)fminf(fmaxf(q, -127.0f), 127.0f) : (int8_t)0;
  }
}

}  // namespace

extern "C" int hegp_quantize_group(const void* x, void* values, void* scales, const void* table,
                                   int64_t leaves, int64_t blocks, void* stream) {
  if (leaves <= 0 || leaves > 0x7fffffff || blocks <= 0 || blocks > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  quantize_group_kernel<<<(unsigned int)blocks, dim3(kCols, kRows), 0, (cudaStream_t)stream>>>(
      (const float*)x, (int8_t*)values, (float*)scales, (const int64_t*)table, (int)leaves);
  return (int)cudaGetLastError();
}
