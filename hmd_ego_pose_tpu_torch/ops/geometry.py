"""Rotation conversions: host numpy, and the device ops of training.

Copy of ``hmd_ego_pose_tpu/ops/geometry.py``: the numpy half that the data
reader and the evaluator need (``matrix_to_axis_angle`` through scipy's
``Rotation``, as in the JAX package, and ``np_axis_angle_to_matrix``), and
the jnp half that the loss and the 6-DoF augmentation need, in torch with
the same operations in the same order (``separate_axis_from_angle``,
``rotate_points``, ``rotate_points_axis_angle``, ``axis_angle_to_matrix``).
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-12


def matrix_to_axis_angle(matrix):
    """Rotation matrix (..., 3, 3) -> compact axis-angle (..., 3), float64.

    scipy's implementation handles the angle ~ 0 and angle ~ pi branch cuts.
    """
    from scipy.spatial.transform import Rotation

    m = np.asarray(matrix, dtype=np.float64)
    out = Rotation.from_matrix(m.reshape(-1, 3, 3)).as_rotvec()
    return out.reshape(m.shape[:-2] + (3,))


def np_axis_angle_to_matrix(axis_angle):
    """Compact axis-angle (..., 3) -> rotation matrix (..., 3, 3), float64 Rodrigues."""
    v = np.asarray(axis_angle, dtype=np.float64)
    angle = np.linalg.norm(v, axis=-1, keepdims=True)
    safe = np.where(angle > _EPS, angle, 1.0)
    a = np.where(angle > _EPS, v / safe, 0.0)
    x, y, z = a[..., 0], a[..., 1], a[..., 2]
    zero = np.zeros_like(x)
    k = np.stack(
        [
            np.stack([zero, -z, y], axis=-1),
            np.stack([z, zero, -x], axis=-1),
            np.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )
    t = angle[..., None]
    return np.eye(3) + np.sin(t) * k + (1.0 - np.cos(t)) * (k @ k)


def separate_axis_from_angle(axis_angle: torch.Tensor):
    """Compact axis-angle (..., 3) -> unit axis (..., 3) and angle (..., 1); a zero
    vector gives axis 0 and angle 0."""
    angle = torch.sqrt(torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True))
    big = angle > _EPS
    axis = torch.where(big, axis_angle / torch.where(big, angle, torch.ones_like(angle)),
                       torch.zeros_like(axis_angle))
    return axis, angle


def rotate_points(points: torch.Tensor, axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: v cos t + (a x v) sin t + a (a . v)(1 - cos t), broadcast over (..., P, 3)."""
    cos_t = torch.cos(angle)
    sin_t = torch.sin(angle)
    a_dot_v = torch.sum(axis * points, dim=-1, keepdim=True)
    axis = axis.expand_as(points)
    a_cross_v = torch.linalg.cross(axis, points, dim=-1)
    return points * cos_t + a_cross_v * sin_t + axis * a_dot_v * (1.0 - cos_t)


def rotate_points_axis_angle(points: torch.Tensor, axis_angle: torch.Tensor) -> torch.Tensor:
    """Rotate (..., P, 3) points by compact (..., 3) axis-angle vectors."""
    axis, angle = separate_axis_from_angle(axis_angle)
    return rotate_points(points, axis[..., None, :], angle[..., None, :])


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Compact axis-angle (..., 3) -> rotation matrix (..., 3, 3), closed-form Rodrigues."""
    angle = torch.sqrt(torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True))
    big = angle > _EPS
    a = torch.where(big, axis_angle / torch.where(big, angle, torch.ones_like(angle)),
                    torch.zeros_like(axis_angle))
    x, y, z = a[..., 0], a[..., 1], a[..., 2]
    t = angle[..., 0]
    c, s = torch.cos(t), torch.sin(t)
    omc = 1.0 - c
    row0 = torch.stack([c + x * x * omc, x * y * omc - z * s, x * z * omc + y * s], dim=-1)
    row1 = torch.stack([y * x * omc + z * s, c + y * y * omc, y * z * omc - x * s], dim=-1)
    row2 = torch.stack([z * x * omc - y * s, z * y * omc + x * s, c + z * z * omc], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)
