"""IoU matrices: the anchor-IoU kernel of target assignment, its plain
version, and the host numpy IoU of the evaluator's detection matching.

* ``iou_matrix`` launches the hand-written CUDA kernel (``csrc/iou.cu``) on
  CUDA tensors, once for a whole batch: the one-call counterpart of the TPU
  kernel ``iou_matrix_pallas`` (``hmd_ego_pose_tpu/ops/pallas_kernels.py``).
  The train step does not call it: its target assignment computes the same
  IoU inside ``csrc/target_assign.cu`` (``ops/target_assign.py``);
* ``iou_matrix_reference`` is the plain PyTorch version, the arithmetic of
  ``hmd_ego_pose_tpu/ops/iou.py::iou_matrix`` in the same order, one
  rounding per operation, so the kernel equals it bit for bit;
* ``iou_matrix_np`` is a copy of the JAX package's float64 host twin.

The device IoU that NMS uses is ``ops/nms.py::iou_matrix``.
"""

from __future__ import annotations

import numpy as np
import torch

from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
from hmd_ego_pose_tpu_torch.kernels import build


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


def iou_matrix(anchors: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """(N, 4) or (B, N, 4) anchors x (B, K, 4) boxes, float32 -> (B, N, K) IoU.

    On CUDA tensors this launches the hand-written kernel once for the whole
    batch, on the current stream, or raises: a build or launch failure is
    never hidden behind the plain version.  Tensors on the CPU take the plain
    version.
    """
    if anchors.dtype != torch.float32 or anchors.dim() not in (2, 3) or anchors.shape[-1] != 4:
        raise ValueError(f"anchors must be float32 (N, 4) or (B, N, 4), got {anchors.dtype} {tuple(anchors.shape)}")
    if gt_boxes.dtype != torch.float32 or gt_boxes.dim() != 3 or gt_boxes.shape[-1] != 4:
        raise ValueError(f"gt_boxes must be float32 (B, K, 4), got {gt_boxes.dtype} {tuple(gt_boxes.shape)}")
    batch, k = gt_boxes.shape[0], gt_boxes.shape[1]
    if anchors.dim() == 3 and anchors.shape[0] != batch:
        raise ValueError(f"batch sizes differ: anchors {anchors.shape[0]}, gt_boxes {batch}")
    if anchors.device.type == "cpu" and gt_boxes.device.type == "cpu":
        return iou_matrix_reference(anchors, gt_boxes)
    if anchors.device.type != "cuda" or gt_boxes.device != anchors.device:
        raise ValueError(f"iou_matrix needs both box sets on one CUDA device, got "
                         f"{anchors.device} and {gt_boxes.device}")
    if not (anchors.is_contiguous() and gt_boxes.is_contiguous()):
        raise ValueError("iou_matrix needs contiguous box sets")
    n = anchors.shape[-2]
    out = torch.empty((batch, n, k), dtype=torch.float32, device=anchors.device)
    if batch == 0 or n == 0 or k == 0:
        return out
    lib = build.library("iou")
    stream = torch.cuda.current_stream(anchors.device).cuda_stream
    rc = lib.hegp_iou(anchors.data_ptr(), gt_boxes.data_ptr(), out.data_ptr(), batch, n, k,
                      n * 4 if anchors.dim() == 3 else 0, stream)
    if rc != 0:
        raise RuntimeError(f"iou kernel launch failed: cudaError {rc}")
    LAUNCHES.add("iou")
    return out


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
