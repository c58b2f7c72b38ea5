// The anchor / ground-truth IoU arithmetic of target_assign.cu.
//
// Written with the _rn intrinsics in the order of the plain PyTorch version
// ops/iou.py::iou_matrix_reference (the jnp order of
// hmd_ego_pose_tpu/ops/iou.py): nvcc would otherwise contract a*b + c into
// an FMA, and the kernel is bit-equal to its plain version.  min and
// max propagate NaN, as torch.minimum / torch.maximum do.
#pragma once

namespace hegp {

__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

// IoU of box a (area area_a) against box b (area area_b); 0 where the union
// is not positive
__device__ __forceinline__ float iou(float ax1, float ay1, float ax2, float ay2, float area_a,
                                     float bx1, float by1, float bx2, float by2, float area_b) {
  const float iw = nan_max(__fsub_rn(nan_min(ax2, bx2), nan_max(ax1, bx1)), 0.f);
  const float ih = nan_max(__fsub_rn(nan_min(ay2, by2), nan_max(ay1, by1)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

}  // namespace hegp
