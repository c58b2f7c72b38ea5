"""IoU matrices: the plain anchor IoU of target assignment, and the host
numpy IoU of the evaluator's detection matching.

* ``iou_matrix_reference`` is the plain PyTorch anchor IoU, the arithmetic of
  ``hmd_ego_pose_tpu/ops/iou.py::iou_matrix`` in the same order, one
  rounding per operation.  The counterpart of the TPU kernel
  ``iou_matrix_pallas`` (``hmd_ego_pose_tpu/ops/pallas_kernels.py``) is
  ``csrc/target_assign.cu``, which computes the same IoU (``csrc/iou.cuh``)
  inside the target assignment, bit for bit; the plain target assignment
  (``ops/target_assign.py``) calls this one;
* ``iou_matrix_np`` is a copy of the JAX package's float64 host twin.

The device IoU that NMS uses is ``ops/nms.py::iou_matrix``.
"""

from __future__ import annotations

import numpy as np
import torch



def iou_matrix_reference(anchors: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """(N, 4) or (B, N, 4) x (B, K, 4) float32 boxes -> (B, N, K) IoU, 0 where union <= 0."""
    if anchors.dim() == 2:
        anchors = anchors.unsqueeze(0)
    a = anchors[:, :, None, :]  # (B|1, N, 1, 4)
    b = gt_boxes[:, None, :, :]  # (B, 1, K, 4)
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def iou_matrix_np(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N, 4) x (K, 4) boxes (x1, y1, x2, y2) -> (N, K) float64 IoU, 0 where union <= 0."""
    a = boxes_a[:, None, :].astype(np.float64)
    b = boxes_b[None, :, :].astype(np.float64)
    iw = np.clip(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), 0.0, None)
    ih = np.clip(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), 0.0, None)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)
