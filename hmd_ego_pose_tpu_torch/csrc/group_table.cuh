// The table of a grouped launch (dequantize.cu, quantize.cu).
//
// A group is many (R, C) leaves packed into flat buffers.  The table has one
// row of six int64 per leaf, built on the host by
// ops/quantization.py::group_table:
//   input offset, scales offset, output offset, R, C, first block.
// Offsets count elements of their buffer.  Rows are in order of first block,
// and a leaf with no block has the next leaf's first block, so block b
// belongs to the last leaf whose first block is <= b.
#pragma once

#include <stdint.h>

namespace hegp {

constexpr int kTableCols = 6;

struct Leaf {
  int64_t in, scales, out, rows, cols, first;
};

__device__ __forceinline__ int64_t load(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

// The leaf of block b: a binary search over the first-block column, at most
// ceil(log2(leaves)) steps (8 for the 137 leaves of the shipped artifact).
__device__ __forceinline__ Leaf leaf_of_block(const int64_t* __restrict__ table, int leaves, int64_t b) {
  int lo = 0, hi = leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (load(table + (int64_t)mid * kTableCols + 5) <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int64_t* row = table + (int64_t)lo * kTableCols;
  return {load(row), load(row + 1), load(row + 2), load(row + 3), load(row + 4), load(row + 5)};
}

}  // namespace hegp
