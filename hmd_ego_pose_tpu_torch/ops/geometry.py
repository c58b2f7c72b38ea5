"""Host-side rotation conversions in numpy.

Copy of the numpy half of ``hmd_ego_pose_tpu/ops/geometry.py`` that the data
reader and the evaluator need: ``matrix_to_axis_angle`` (scipy's
``Rotation``, as in the JAX package) and ``np_axis_angle_to_matrix``.
"""

from __future__ import annotations

import numpy as np

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
