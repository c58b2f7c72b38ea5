"""Anchor target assignment on the device, over a whole batch at once.

Counterpart of ``hmd_ego_pose_tpu/ops/target_assign.py``, whose
``assign_targets`` the JAX train step vmaps over the images of a batch,
around the TPU kernel ``iou_matrix_pallas``.  Here the batch is a leading
dimension:

* ``assign_targets_batch`` launches the hand-written CUDA kernel
  (``csrc/target_assign.cu``) on CUDA tensors: the IoU, both argmaxes, the
  thresholds, the forced positives, ``bbox_transform`` and the gathers of
  the assigned ground-truth rows in two launches, counted once;
* ``assign_targets_batch_reference`` is the plain PyTorch version, the JAX
  package's operations in the same order on ``ops/iou.py::iou_matrix_reference``;
  the kernel equals it bit for bit.

Semantics, as in the JAX package:

* positive: IoU >= ``positive_overlap``, and each ground-truth row's best
  anchor is forced positive;
* ignore: IoU > ``negative_overlap`` but not positive, and every anchor
  whose centre lies outside the image;
* an image without valid ground truth is all negative, out-of-image anchors
  ignored;
* regression, transformation and hand targets come from each anchor's
  best-overlap ground-truth row, for every anchor (the loss masks them).

The forced positives are a scatter with repeated indices: a padded row's
IoU column is all -1, so its best anchor is anchor 0.  XLA's scatter lands
the rows in order and the last one wins (a padded row after a valid row
with the same best anchor clears that anchor's force).  A CUDA
``index_put_`` with repeated indices lands them in no fixed order, so each
image writes only the last of the rows that share an anchor, which gives
XLA's result with every index written once; the kernel takes, per anchor,
the last row whose best anchor it is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hmd_ego_pose_tpu_torch.kernels import launch
from hmd_ego_pose_tpu_torch.ops.iou import iou_matrix_reference


class AnchorTargets(NamedTuple):
    """Per-anchor training targets, (B, N, ...).  ``state``: -1 ignore, 0 negative, 1 positive."""

    labels: torch.Tensor  # (B, N, num_classes) one-hot for positives
    regression: torch.Tensor  # (B, N, 4) (ty, tx, th, tw)
    transformation: torch.Tensor  # (B, N, 8) rot(3)/pi, trans(3), is_sym, class
    coords_3d: torch.Tensor  # (B, N, 63) hand joints
    state: torch.Tensor  # (B, N) float32


def bbox_transform(anchors: torch.Tensor, gt_boxes: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Box regression targets (ty, tx, th, tw) of (..., 4) boxes against (..., 4) anchors."""
    wa = anchors[..., 2] - anchors[..., 0]
    ha = anchors[..., 3] - anchors[..., 1]
    cxa = anchors[..., 0] + wa / 2.0
    cya = anchors[..., 1] + ha / 2.0

    w = gt_boxes[..., 2] - gt_boxes[..., 0]
    h = gt_boxes[..., 3] - gt_boxes[..., 1]
    cx = gt_boxes[..., 0] + w / 2.0
    cy = gt_boxes[..., 1] + h / 2.0

    ha = ha + eps
    wa = wa + eps
    h = h + eps
    w = w + eps

    ty = (cy - cya) / ha
    tx = (cx - cxa) / wa
    th = torch.log(h / ha)
    tw = torch.log(w / wa)
    return torch.stack([ty, tx, th, tw], dim=-1)


def _forced_positive(best_anchor: torch.Tensor, gt_valid: torch.Tensor, n: int) -> torch.Tensor:
    """(B, K) best anchor per ground-truth row -> (B, N) bool: ``zeros.at[best].set(valid)``
    with XLA's order (rows land in order, the last of a repeated index wins)."""
    b, k = best_anchor.shape
    later = torch.triu(torch.ones((k, k), dtype=torch.bool, device=best_anchor.device), diagonal=1)
    repeated_later = ((best_anchor[:, :, None] == best_anchor[:, None, :]) & later).any(dim=2)
    # rows overwritten by a later row write into a spare column N, dropped after
    target = torch.where(repeated_later, torch.full_like(best_anchor, n), best_anchor)
    force = torch.zeros((b, n + 1), dtype=torch.bool, device=best_anchor.device)
    force.scatter_(1, target, gt_valid & ~repeated_later)
    return force[:, :n]


def assign_targets_batch_reference(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_transformation: torch.Tensor,
    gt_coords_3d: torch.Tensor,
    gt_valid: torch.Tensor,
    num_classes: int,
    image_size: int,
    positive_overlap: float = 0.5,
    negative_overlap: float = 0.4,
) -> AnchorTargets:
    """Targets of B images over padded ground truth, in plain PyTorch.

    Args:
        anchors: (N, 4) float32, shared by the batch.
        gt_boxes: (B, K, 4) float32, padded rows arbitrary.
        gt_labels: (B, K) integer.
        gt_transformation: (B, K, 8).
        gt_coords_3d: (B, K, 63).
        gt_valid: (B, K) bool, False rows are padding.
    """
    n = anchors.shape[0]
    overlaps = iou_matrix_reference(anchors, gt_boxes)  # (B, N, K)
    # padding must never win an argmax
    overlaps = torch.where(gt_valid[:, None, :], overlaps, torch.full_like(overlaps, -1.0))

    argmax_gt = overlaps.argmax(dim=2)  # (B, N), first index among ties as jnp.argmax
    max_overlap = overlaps.amax(dim=2)

    any_valid = gt_valid.any(dim=1, keepdim=True)  # (B, 1)
    positive = max_overlap >= positive_overlap
    positive = positive | _forced_positive(overlaps.argmax(dim=1), gt_valid, n)
    ignore = (max_overlap > negative_overlap) & ~positive

    cx = (anchors[:, 0] + anchors[:, 2]) / 2
    cy = (anchors[:, 1] + anchors[:, 3]) / 2
    outside = ((cx >= image_size) | (cy >= image_size))[None, :]  # (1, N)

    one, zero, minus = (torch.tensor(v, dtype=torch.float32, device=anchors.device) for v in (1.0, 0.0, -1.0))
    state = torch.where(positive, one, zero)
    state = torch.where(ignore, minus, state)
    state = torch.where(outside, minus, state)
    state = torch.where(any_valid, state, torch.where(outside, minus, zero))

    def assigned(x: torch.Tensor) -> torch.Tensor:  # (B, K, D) -> (B, N, D) rows of argmax_gt
        return torch.gather(x, 1, argmax_gt[:, :, None].expand(-1, -1, x.shape[-1]))

    labels = torch.gather(gt_labels.long(), 1, argmax_gt)
    classes = torch.arange(num_classes, device=anchors.device)
    # a label outside [0, num_classes) is an all-zero row, as jax.nn.one_hot gives
    labels_onehot = (labels[:, :, None] == classes).float() * (state == 1.0)[:, :, None].float()
    regression = bbox_transform(anchors[None], assigned(gt_boxes.float()))
    return AnchorTargets(
        labels=labels_onehot,
        regression=regression.float(),
        transformation=assigned(gt_transformation.float()),
        coords_3d=assigned(gt_coords_3d.float()),
        state=state,
    )


_TARGET_DTYPES = (("anchors", torch.float32, 2), ("gt_boxes", torch.float32, 3), ("gt_labels", torch.int32, 2),
                  ("gt_transformation", torch.float32, 3), ("gt_coords_3d", torch.float32, 3),
                  ("gt_valid", torch.bool, 2))


def assign_targets_batch(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_transformation: torch.Tensor,
    gt_coords_3d: torch.Tensor,
    gt_valid: torch.Tensor,
    num_classes: int,
    image_size: int,
    positive_overlap: float = 0.5,
    negative_overlap: float = 0.4,
) -> AnchorTargets:
    """Targets of B images over padded ground truth (``assign_targets_batch_reference``'s
    arguments, with ``gt_labels`` int32 and ``gt_valid`` bool).

    On CUDA tensors this launches the hand-written kernel (two launches, one
    count) on the current stream, or raises: a build or launch failure is
    never hidden behind the plain version.  Tensors on the CPU take the plain
    version.
    """
    args = (anchors, gt_boxes, gt_labels, gt_transformation, gt_coords_3d, gt_valid)
    for (name, dtype, dim), x in zip(_TARGET_DTYPES, args):
        if x.dtype != dtype or x.dim() != dim:
            raise ValueError(f"{name} must be {dtype} with {dim} dimensions, got {x.dtype} {tuple(x.shape)}")
    n, (b, k) = anchors.shape[0], gt_boxes.shape[:2]
    shapes = [x.shape[:2] for x in (gt_labels, gt_transformation, gt_coords_3d, gt_valid)]
    if anchors.shape[1] != 4 or gt_boxes.shape[2] != 4 or k == 0 or any(sh != (b, k) for sh in shapes):
        raise ValueError(f"shapes must be anchors (N, 4) and ground truth (B, K >= 1, ...), got "
                         f"{[tuple(x.shape) for x in args]}")
    if num_classes < 1:
        raise ValueError(f"num_classes must be at least 1, got {num_classes}")
    if all(x.device.type == "cpu" for x in args):
        return assign_targets_batch_reference(*args, num_classes=num_classes, image_size=image_size,
                                              positive_overlap=positive_overlap,
                                              negative_overlap=negative_overlap)
    device = anchors.device
    if device.type != "cuda" or any(x.device != device for x in args):
        raise ValueError(f"assign_targets_batch needs every tensor on one CUDA device, got "
                         f"{[str(x.device) for x in args]}")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("assign_targets_batch needs contiguous tensors")
    dt, dc = gt_transformation.shape[2], gt_coords_3d.shape[2]
    f32 = dict(dtype=torch.float32, device=device)
    out = AnchorTargets(labels=torch.empty((b, n, num_classes), **f32), regression=torch.empty((b, n, 4), **f32),
                        transformation=torch.empty((b, n, dt), **f32), coords_3d=torch.empty((b, n, dc), **f32),
                        state=torch.empty((b, n), **f32))
    if b == 0 or n == 0:
        return out
    best = torch.empty((b, k), dtype=torch.int32, device=device)  # scratch: best anchor per row
    # thresholds and the image size compare in float32, as torch compares a float32 tensor with a scalar
    scalars = (float(np.float32(image_size)), float(np.float32(positive_overlap)), float(np.float32(negative_overlap)))
    launch("target_assign", "hegp_target_assign", device, *(x.data_ptr() for x in args), best.data_ptr(),
           *(x.data_ptr() for x in out), b, n, k, num_classes, dt, dc, *scalars)
    return out
