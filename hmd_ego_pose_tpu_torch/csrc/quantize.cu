// Symmetric per-channel int8 quantize of an (R, C) float32 array:
// scale[c] = max(max_r |x[r, c]|, 1e-12) / 127 and
// values[r, c] = clip(round_half_even(x[r, c] / scale[c]), -127, 127).
//
// Replaces the TPU kernel hmd_ego_pose_tpu/ops/quantization.py
// (_quantize_kernel / quantize_pallas).  It computes what the JAX package's
// int8 save computes, quantize_np (numpy), not the Pallas kernel block by
// block: the Pallas kernel pads R to 32 and C to 128 and holds the whole
// array in VMEM, and XLA turns its "/ 127.0" into a multiply by float32(1/127),
// which gives scales one ulp off numpy's in a few percent of the columns.
// Here both divisions are IEEE divisions (__fdiv_rn), so the kernel is
// bit-equal to quantize_np and to the plain PyTorch version
// ops/quantization.py::quantize_reference.
//
// Bound: bytes.  Each value is read as 4 bytes and written as 1, with a
// handful of operations (abs, max, divide, round, clip) per value, far below
// the card's ridge point.  This kernel reads x twice (once for the column
// maxima, once to quantize), so it moves 9 bytes per value where the bound
// counts 5; the second read of a leaf of the shipped artifact (at most
// 1.5 MB) mostly hits L2.  Over the 137 leaves of an export, launch cost and
// not bytes dominates (as for dequantize.cu); one launch over all the leaves
// is later work.
//
// Design: a block covers a tile of 32 consecutive columns with 32 x 16
// threads; threadIdx.x is the column, so each warp's loads and stores are
// coalesced along the row-major C axis, and the 16 row threads stride down
// the rows.  The column maxima are reduced through shared memory (max is
// exact, so the order does not matter), the scale is written by row thread
// 0, and the same block then quantizes its columns.
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

namespace {

constexpr int kCols = 32;  // columns per block: one warp's width
constexpr int kRows = 16;  // row threads per block

// max that keeps NaN from either side, as np.max / np.maximum do (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void quantize_kernel(const float* __restrict__ x,
                                int8_t* __restrict__ values,
                                float* __restrict__ scales,
                                int64_t rows, int64_t cols) {
  __shared__ float partial[kRows][kCols];
  __shared__ float tile_scale[kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t c = (int64_t)blockIdx.x * kCols + tx;
  const bool in = c < cols;

  float m = 0.0f;
  if (in) {
    for (int64_t r = ty; r < rows; r += kRows) {
      m = max_nan(m, fabsf(x[r * cols + c]));
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
      scales[c] = s;
    }
  }
  __syncthreads();
  if (!in) {
    return;
  }
  const float s = tile_scale[tx];
  for (int64_t r = ty; r < rows; r += kRows) {
    const float q = rintf(__fdiv_rn(x[r * cols + c], s));
    values[r * cols + c] = (q == q) ? (int8_t)fminf(fmaxf(q, -127.0f), 127.0f) : (int8_t)0;
  }
}

}  // namespace

extern "C" int hegp_quantize(const void* x, void* values, void* scales,
                             int64_t rows, int64_t cols, void* stream) {
  if (rows <= 0 || cols <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = (cols + kCols - 1) / kCols;
  if (blocks > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  quantize_kernel<<<(unsigned int)blocks, dim3(kCols, kRows), 0, (cudaStream_t)stream>>>(
      (const float*)x, (int8_t*)values, (float*)scales, rows, cols);
  return (int)cudaGetLastError();
}
