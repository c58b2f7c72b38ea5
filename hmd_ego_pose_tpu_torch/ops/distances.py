"""Point-set distances of the ADD and ADD-S metrics: the min-distance kernel's
wrapper and its plain version.

Counterpart of ``hmd_ego_pose_tpu/ops/distances.py`` and of the TPU kernel
``min_distances_pallas`` (``hmd_ego_pose_tpu/ops/pallas_kernels.py``), which
the JAX evaluator vmaps over the true-positive pose pairs of a class.  Here
the pairs are a leading batch dimension T:

* ``min_distances`` launches the hand-written CUDA kernel
  (``csrc/min_distances.cu``) on CUDA tensors, once for all T pairs;
* ``min_distances_reference`` is the plain PyTorch version, with the same
  arithmetic in the same order (direct differences, ``dx*dx + dy*dy`` then
  ``+ dz*dz``, min, square root), so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
from hmd_ego_pose_tpu_torch.kernels import build

# pairs per step of the plain version: bounds its (chunk, P, Q) planes
_REFERENCE_ELEMENTS = 1 << 24


def paired_distances(points_a: torch.Tensor, points_b: torch.Tensor) -> torch.Tensor:
    """(..., P, 3) x (..., P, 3) -> (..., P) Euclidean row distances (ADD)."""
    return torch.linalg.norm(points_a - points_b, dim=-1)


def min_distances_reference(points_gt: torch.Tensor, points_pred: torch.Tensor) -> torch.Tensor:
    """(T, P, 3) x (T, Q, 3) float32 -> (T, P): per GT point, the least distance to a pred point.

    Plain PyTorch, each operation its own rounding step; pairs are taken a
    few at a time so the (P, Q) planes stay small.
    """
    t, p, q = points_gt.shape[0], points_gt.shape[1], points_pred.shape[1]
    step = max(1, _REFERENCE_ELEMENTS // max(1, p * q))
    out = []
    for s in range(0, t, step):
        g = points_gt[s:s + step, :, None, :]
        pr = points_pred[s:s + step, None, :, :]
        dx = g[..., 0] - pr[..., 0]
        dy = g[..., 1] - pr[..., 1]
        dz = g[..., 2] - pr[..., 2]
        d2 = dx * dx + dy * dy
        d2 = d2 + dz * dz
        out.append(torch.sqrt(d2.amin(dim=-1)))
    return torch.cat(out) if out else points_gt.new_empty((0, p))


def min_distances(points_gt: torch.Tensor, points_pred: torch.Tensor) -> torch.Tensor:
    """(T, P, 3) x (T, Q, 3) float32 -> (T, P) min Euclidean distances.

    On CUDA tensors this launches the hand-written kernel once, on the
    current stream, or raises: a build or launch failure is never hidden
    behind the plain version.  Tensors on the CPU take the plain version.
    """
    for name, x in (("points_gt", points_gt), ("points_pred", points_pred)):
        if x.dim() != 3 or x.shape[-1] != 3 or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (T, N, 3), got {x.dtype} {tuple(x.shape)}")
    if points_gt.shape[0] != points_pred.shape[0]:
        raise ValueError(f"pose-pair counts differ: {points_gt.shape[0]} and {points_pred.shape[0]}")
    if points_pred.shape[1] == 0:
        raise ValueError("min_distances needs at least one predicted point")
    if points_gt.device.type == "cpu" and points_pred.device.type == "cpu":
        return min_distances_reference(points_gt, points_pred)
    if points_gt.device.type != "cuda" or points_pred.device != points_gt.device:
        raise ValueError(
            f"min_distances needs both point sets on one CUDA device, got "
            f"{points_gt.device} and {points_pred.device}"
        )
    if not (points_gt.is_contiguous() and points_pred.is_contiguous()):
        raise ValueError("min_distances needs contiguous point sets")
    t, p, q = points_gt.shape[0], points_gt.shape[1], points_pred.shape[1]
    out = torch.empty((t, p), dtype=torch.float32, device=points_gt.device)
    if t == 0 or p == 0:
        return out
    lib = build.library("min_distances")
    stream = torch.cuda.current_stream(points_gt.device).cuda_stream
    rc = lib.hegp_min_distances(points_gt.data_ptr(), points_pred.data_ptr(), out.data_ptr(),
                                t, p, q, stream)
    if rc != 0:
        raise RuntimeError(f"min_distances kernel launch failed: cudaError {rc}")
    LAUNCHES.add("min_distances")
    return out
