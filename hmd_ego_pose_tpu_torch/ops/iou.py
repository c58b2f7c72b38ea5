"""Host IoU matrix in numpy, for the evaluator's detection matching.

Copy of ``iou_matrix_np`` of ``hmd_ego_pose_tpu/ops/iou.py``.  The device IoU
that NMS uses is ``ops/nms.py::iou_matrix``.
"""

from __future__ import annotations

import numpy as np


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
