// Per-channel int8 dequantize of a group of leaves in one launch:
// out[r, c] = float(values[r, c]) * scales[c] for every (R, C) leaf.
//
// Replaces the TPU kernel hmd_ego_pose_tpu/ops/quantization.py:64
// (dequantize_pallas, kernel _dequantize_kernel), which the JAX package's
// restore computes on the host with numpy (dequantize_tree).  The port runs
// it on the card: the int8 restore packs every int8 leaf of an artifact on
// the host, uploads the packed values, the packed scales and the table
// (group_table.cuh) once each, and launches this kernel once.
//
// Bound: bytes.  Each value reads 1 byte and writes 4, one multiply per 5
// bytes, far below the card's ridge point: 19.4 MB for the 137 leaves of the
// shipped artifact, 0.0058 ms at 3.35 TB/s.  Launched once per leaf, the
// kernel was bound by the host's time per launch instead (about 20 us per
// leaf); one launch for the group removes that.  Nothing is reused and
// nothing is multiplied as a matrix, so TMA and wgmma have no work here.
//
// Design: each block takes 4,096 values of one leaf (256 threads x 16), about
// 1,000 blocks for the shipped artifact, enough for 132 SMs.  A block finds
// its leaf by a binary search over the table's first-block column.  A thread
// makes one 16-byte load of int8 values and four float4 stores; the host
// starts every leaf at a multiple of 16 values, so both are aligned (a chunk
// that is not, or that crosses the leaf's end, takes a scalar loop).  The
// column runs along with the value (one division per thread, none per value),
// and the scales come through the read-only cache.  One float multiply of
// exact operands, so the result is bit-equal to the plain version
// ops/quantization.py::dequantize_reference.
//
// Interface: plain C (no PyTorch headers), loaded with ctypes.  The launcher
// takes device pointers and the caller's stream, allocates nothing, does not
// synchronise and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "group_table.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;  // one 16-byte int8 load, four float4 stores
constexpr int64_t kPerBlock = (int64_t)kThreads * kPerThread;  // 4,096 values

__global__ void __launch_bounds__(kThreads)
dequantize_group_kernel(const int8_t* __restrict__ values, const float* __restrict__ scales,
                        float* __restrict__ out, const int64_t* __restrict__ table, int leaves) {
  const int64_t b = blockIdx.x;
  const hegp::Leaf leaf = hegp::leaf_of_block(table, leaves, b);
  const int64_t n = leaf.rows * leaf.cols;
  const int64_t start = (b - leaf.first) * kPerBlock + (int64_t)threadIdx.x * kPerThread;
  if (start >= n) {
    return;
  }
  const int8_t* v = values + leaf.in + start;
  const float* s = scales + leaf.scales;
  float* o = out + leaf.out + start;
  int64_t c = start % leaf.cols;
  const bool aligned = ((reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  if (aligned && start + kPerThread <= n) {
    union {
      int4 vec;
      int8_t q[kPerThread];
    } in;
    in.vec = __ldg(reinterpret_cast<const int4*>(v));
    float r[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      r[k] = (float)in.q[k] * __ldg(s + c);
      if (++c == leaf.cols) {
        c = 0;
      }
    }
    float4* o4 = reinterpret_cast<float4*>(o);
#pragma unroll
    for (int k = 0; k < kPerThread / 4; ++k) {
      o4[k] = make_float4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
    }
  } else {
    const int64_t m = n - start < kPerThread ? n - start : kPerThread;
    for (int64_t k = 0; k < m; ++k) {
      o[k] = (float)v[k] * __ldg(s + c);
      if (++c == leaf.cols) {
        c = 0;
      }
    }
  }
}

}  // namespace

extern "C" int hegp_dequantize_group(const void* values, const void* scales, void* out, const void* table,
                                     int64_t leaves, int64_t blocks, void* stream) {
  if (leaves <= 0 || leaves > 0x7fffffff || blocks <= 0 || blocks > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  dequantize_group_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)values, (const float*)scales, (float*)out, (const int64_t*)table, (int)leaves);
  return (int)cudaGetLastError();
}
