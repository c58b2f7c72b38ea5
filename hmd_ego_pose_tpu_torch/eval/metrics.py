"""6-DoF pose metrics: ADD, ADD-S, 5cm-5deg (+ drill tip), 2-D reprojection, AP.

Counterpart of ``hmd_ego_pose_tpu/eval/metrics.py``.  The per-detection
checkers are the same numpy code with the same thresholds:

* ADD: mean paired distance of the transformed model points <= 0.1 x diameter;
* ADD-S: mean *minimum* distance, on the stride subsample
  ``step = num_points // max_points + 1``;
* 5cm-5deg: translation distance <= 50 mm and geodesic rotation <= 5 deg,
  plus the drill-tip distance through the homogeneous tip offset;
* 2-D reprojection: mean projected pixel distance <= 5 px;
* AP: the py-faster-rcnn precision-envelope integral.

``add_s_batch`` scores every true-positive pose pair of a class at once: both
point sets of all T pairs are transformed in float32 on the evaluation's
device, and one ``ops/distances.py::min_distances`` call (one launch of the
CUDA kernel on the card) takes the min distances for all of them.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from hmd_ego_pose_tpu_torch.ops.distances import min_distances
from hmd_ego_pose_tpu_torch.utils.device import DeviceLike, resolve_device


def transform_points(points: np.ndarray, rotation: np.ndarray, translation: np.ndarray):
    """(P, 3) points through R, t."""
    return points @ rotation.T + translation


def translation_diff(t_gt: np.ndarray, t_pred: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(t_gt) - np.asarray(t_pred)))


def rotation_diff_degrees(r_gt: np.ndarray, r_pred: np.ndarray) -> float:
    """Geodesic angle between rotation matrices, in degrees."""
    trace = np.clip((np.trace(r_pred @ r_gt.T) - 1.0) / 2.0, -1.0, 1.0)
    return float(abs(np.degrees(np.arccos(trace))))


def check_add(
    model_points, diameter, r_gt, t_gt, r_pred, t_pred, diameter_threshold=0.1
) -> Tuple[bool, float]:
    """ADD metric; returns (is_correct, mean_distance)."""
    pts_gt = transform_points(model_points, r_gt, t_gt)
    pts_pred = transform_points(model_points, r_pred, t_pred)
    mean_d = float(np.mean(np.linalg.norm(pts_gt - pts_pred, axis=-1)))
    return mean_d <= diameter * diameter_threshold, mean_d


def check_add_s(
    model_points, diameter, r_gt, t_gt, r_pred, t_pred,
    diameter_threshold=0.1, max_points=1000,
) -> Tuple[bool, float]:
    """ADD-S of one pose pair in float64 numpy, with the stride subsample."""
    pts_gt = transform_points(model_points, r_gt, t_gt)
    pts_pred = transform_points(model_points, r_pred, t_pred)
    step = pts_gt.shape[0] // max_points + 1
    a = pts_gt[::step]
    b = pts_pred[::step]
    d2 = np.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1)
    mean_d = float(np.mean(np.sqrt(d2.min(axis=1))))
    return mean_d <= diameter * diameter_threshold, mean_d


def _transform(points: torch.Tensor, rotations: torch.Tensor, translations: torch.Tensor) -> torch.Tensor:
    """(P, 3) x (T, 3, 3) x (T, 3) -> (T, P, 3), elementwise float32 (no matmul, no TF32)."""
    x, y, z = (points[None, :, k, None] for k in range(3))
    return (x * rotations[:, None, :, 0] + y * rotations[:, None, :, 1]
            + z * rotations[:, None, :, 2] + translations[:, None, :])


def add_s_batch(
    model_points: np.ndarray,
    diameter: float,
    poses: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    diameter_threshold: float = 0.1,
    max_points: int = 1000,
    device: DeviceLike = None,
) -> Tuple[List[bool], List[float]]:
    """ADD-S of every (r_gt, t_gt, r_pred, t_pred) pose pair, as one batch on ``device``.

    The same stride subsample as ``check_add_s``; the points are transformed
    in float32 on ``device`` and the min distances of all pairs come from one
    ``min_distances`` call (the CUDA kernel on the card, its plain version on
    the CPU).  ``device=None`` is the card, and raises when there is none.
    Returns (ok_flags, mean_distances) as Python lists.
    """
    device = resolve_device(device)
    if not poses:
        return [], []
    step = model_points.shape[0] // max_points + 1
    sub = torch.from_numpy(np.ascontiguousarray(model_points[::step], np.float32)).to(device)
    rg, tg, rp, tp = (
        torch.from_numpy(np.stack([np.reshape(pose[k], shape) for pose in poses]).astype(np.float32)).to(device)
        for k, shape in ((0, (3, 3)), (1, (3,)), (2, (3, 3)), (3, (3,)))
    )
    d = min_distances(_transform(sub, rg, tg).contiguous(), _transform(sub, rp, tp).contiguous())
    means = d.mean(dim=1).cpu().numpy()
    thr = diameter * diameter_threshold
    return [bool(m <= thr) for m in means], [float(m) for m in means]


def check_5cm_5degree(
    r_gt, t_gt, r_pred, t_pred, drill_tip_h,
    translation_threshold=50.0, rotation_threshold=5.0,
) -> Tuple[bool, float, float, float]:
    """5cm-5deg and the drill-tip distance.

    ``drill_tip_h``: (1, 4) or (4,) homogeneous tip offset in the model frame.
    Returns (is_correct, translation_distance, rotation_distance_deg, tip_distance).
    """
    t_dist = translation_diff(t_gt, t_pred)
    r_dist = rotation_diff_degrees(r_gt, r_pred)
    tip = np.reshape(np.asarray(drill_tip_h, np.float64), (4,))
    pose_gt = np.concatenate([r_gt, np.reshape(t_gt, (3, 1))], axis=1)
    pose_pred = np.concatenate([r_pred, np.reshape(t_pred, (3, 1))], axis=1)
    tip_dist = float(np.linalg.norm(pose_gt @ tip - pose_pred @ tip))
    ok = t_dist <= translation_threshold and r_dist <= rotation_threshold
    return ok, t_dist, r_dist, tip_dist


def check_2d_reprojection(
    model_points, r_gt, t_gt, r_pred, t_pred, camera_matrix, pixel_threshold=5.0
) -> bool:
    """Mean projected pixel distance <= threshold."""
    pts_gt = transform_points(model_points, r_gt, t_gt)
    pts_pred = transform_points(model_points, r_pred, t_pred)

    def project(p):
        z = p[:, 2]
        u = camera_matrix[0, 0] * p[:, 0] / z + camera_matrix[0, 2]
        v = camera_matrix[1, 1] * p[:, 1] / z + camera_matrix[1, 2]
        return np.stack([u, v], axis=1)

    d = np.linalg.norm(project(pts_gt) - project(pts_pred), axis=-1)
    return float(np.mean(d)) <= pixel_threshold


def hand_mpjpe_mm(gt_joints: np.ndarray, pred_joints: np.ndarray) -> float:
    """Mean per-joint position error of 21 joints in meters, reported in mm."""
    d = np.linalg.norm(np.reshape(gt_joints, (21, 3)) - np.reshape(pred_joints, (21, 3)), axis=-1)
    return float(np.mean(d) * 1000.0)


def compute_average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """py-faster-rcnn AP: the integral of the precision envelope over recall."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
