"""Training losses: focal, smooth-L1 (boxes, hands) and the 6-DoF transformation loss.

Counterpart of ``hmd_ego_pose_tpu/losses.py``.  The JAX package computes
each per-image loss and vmaps it over the batch; here every function takes
the batch as a leading dimension and returns one value per image, and
``total_loss`` averages them over the batch as the JAX package does.

The transformation loss reads a fixed slice of ``max_positive_anchors``
anchors per image.  The JAX package takes it with ``lax.top_k`` over a 0/1
positive score, which returns the positives in ascending anchor order and,
below the cap, fills with the lowest-index negatives (masked out).
``torch.topk`` on CUDA promises no order among ties, so the port sorts the
score with a stable descending sort: the same anchors, in the same order,
whatever the device; above the cap the same lowest-index positives are kept.

Symmetric objects take the mean closest-point distance, in the JAX
package's fixed shape: the minimum distance of every anchor of the capped
slice, then a select by ``is_sym`` between it and the paired distance.  No
value is read back and no shape depends on the data, so a CUDA graph of the
train step holds it (``train/step.py``); graph and eager run this one form on
every device.  The minimum needs a (P3D x P3D) distance matrix per anchor:
``min_squared_distance`` computes it ``MIN_DISTANCE_CHUNK`` anchors at a
time and keeps none of it for the backward pass, which computes each chunk
again; its gradient spreads evenly over tied minima, as ``torch.amin``'s
and JAX's ``min``'s do.  ``symmetric`` says whether any ground truth may be
symmetric (a flag fixed per dataset: the trainer passes it); ``False`` skips
the minimum, which changes nothing, since the select would take the paired
distance everywhere.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hmd_ego_pose_tpu_torch.config import LossConfig
from hmd_ego_pose_tpu_torch.ops.geometry import rotate_points_axis_angle
from hmd_ego_pose_tpu_torch.ops.target_assign import AnchorTargets

_PI = 3.141592653589793
# anchors a chunk of the minimum distance: its (chunk, P3D, P3D, 3) differences
# at 500 points are 192 MB, against 6.1 GB for the 2,048 anchors of a batch of
# 16 at two objects (a 128-anchor slice an image)
MIN_DISTANCE_CHUNK = 64


class LossBundle(NamedTuple):
    classification: torch.Tensor
    regression: torch.Tensor
    rotation: torch.Tensor
    translation: torch.Tensor
    hand: torch.Tensor
    total: torch.Tensor


def focal_loss(labels, classification, state, alpha: float = 0.25, gamma: float = 1.5):
    """(B, N, C) one-hot labels and sigmoid scores, (B, N) states -> (B,) focal loss
    over the non-ignored anchors, normalised by the positive count."""
    cls = torch.clamp(classification, 1e-4, 1.0 - 1e-4)
    is_one = labels == 1.0
    alpha_factor = torch.where(is_one, torch.full_like(cls, alpha), torch.full_like(cls, 1.0 - alpha))
    focal_weight = torch.where(is_one, 1.0 - cls, cls)
    focal_weight = alpha_factor * focal_weight ** gamma
    bce = -(labels * torch.log(cls) + (1.0 - labels) * torch.log(1.0 - cls))
    per_anchor = focal_weight * bce
    not_ignored = (state != -1.0)[..., None]
    loss = torch.sum(per_anchor * not_ignored, dim=(1, 2))
    normalizer = torch.clamp(torch.sum(state == 1.0, dim=1).float(), min=1.0)
    return loss / normalizer


def _smooth_l1(diff, sigma: float):
    sigma_sq = sigma ** 2
    adiff = torch.abs(diff)
    return torch.where(adiff <= 1.0 / sigma_sq, 0.5 * sigma_sq * adiff ** 2, adiff - 0.5 / sigma_sq)


def smooth_l1_loss(targets, predictions, state, sigma: float = 3.0):
    """(B, N, D) targets and predictions -> (B,) smooth-L1 over the positive anchors,
    normalised by their count."""
    positive = (state == 1.0)[..., None]
    per_elem = _smooth_l1(predictions - targets, sigma) * positive
    normalizer = torch.clamp(torch.sum(state == 1.0, dim=1).float(), min=1.0)
    return torch.sum(per_elem, dim=(1, 2)) / normalizer


def positive_slice(state: torch.Tensor, cap: int) -> torch.Tensor:
    """(B, N) states -> (B, min(cap, N)) anchor indices: the positives in ascending
    order, then the lowest-index other anchors (``lax.top_k`` of the 0/1 score)."""
    score = (state == 1.0).to(torch.float32)
    _, order = torch.sort(score, dim=1, descending=True, stable=True)
    return order[:, : min(cap, state.shape[1])]


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, D) rows at (B, P) indices -> (B, P, D)."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[-1]))


class _MinSquaredDistance(torch.autograd.Function):
    """(M, P, 3) a, (M, Q, 3) b -> (M, P): ``amin(sum((a_i - b_j) ** 2), j)``
    per row, ``MIN_DISTANCE_CHUNK`` rows at a time; the backward pass
    computes each chunk's squared distances again (nothing of size P x Q is
    saved) and gives each tied minimum an equal share of the gradient."""

    @staticmethod
    def _squared(a, b):
        diff = a[:, :, None, :] - b[:, None, :, :]
        return diff, torch.sum(diff * diff, dim=-1)

    @staticmethod
    def forward(ctx, a, b):
        out = a.new_empty(a.shape[:2])
        for s in range(0, a.shape[0], MIN_DISTANCE_CHUNK):
            e = s + MIN_DISTANCE_CHUNK
            out[s:e] = torch.amin(_MinSquaredDistance._squared(a[s:e], b[s:e])[1], dim=-1)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        a, b, out = ctx.saved_tensors
        need_a, need_b = ctx.needs_input_grad
        grad_a = torch.zeros_like(a) if need_a else None
        grad_b = torch.zeros_like(b) if need_b else None
        for s in range(0, a.shape[0], MIN_DISTANCE_CHUNK):
            e = s + MIN_DISTANCE_CHUNK
            diff, d2 = _MinSquaredDistance._squared(a[s:e], b[s:e])
            ties = d2 == out[s:e, :, None]
            share = grad[s:e, :, None] / torch.sum(ties, dim=-1, keepdim=True)
            g_diff = (2.0 * torch.where(ties, share, torch.zeros_like(share)))[..., None] * diff
            if need_a:
                grad_a[s:e] = torch.sum(g_diff, dim=2)
            if need_b:
                grad_b[s:e] = -torch.sum(g_diff, dim=1)
        return grad_a, grad_b


def min_squared_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, P, 3), (M, Q, 3) -> (M, P): each point of ``a``'s squared distance
    to the closest point of ``b`` in the same row."""
    return _MinSquaredDistance.apply(a, b)


def transformation_loss(gt_transformation, pred_transformation, state, model_3d_points,
                        max_positive_anchors: int = 64, symmetric: bool = True):
    """Rotation point distance and translation smooth-L1 -> two (B,) losses.

    Args:
        gt_transformation: (B, N, 8) [rot/pi (3), trans (3), is_sym, class].
        pred_transformation: (B, N, 6) [rot/pi (3), trans (3)], translation in mm.
        state: (B, N) anchor states.
        model_3d_points: (num_classes, P3D, 3) float32.
    """
    positive = state == 1.0
    num_pos = torch.sum(positive.to(torch.float32), dim=1)
    idx = positive_slice(state, max_positive_anchors)
    valid = torch.gather(positive, 1, idx)  # (B, P)
    gt = _gather(gt_transformation, idx)
    pred = _gather(pred_transformation, idx)

    rot_pred = pred[..., :3] * _PI
    rot_gt = gt[..., :3] * _PI
    trans_pred = pred[..., 3:6]
    trans_gt = gt[..., 3:6]
    is_sym = torch.round(gt[..., 6]) == 1.0
    class_idx = torch.round(gt[..., 7]).long()

    points = model_3d_points[class_idx]  # (B, P, P3D, 3)
    rotated_pred = rotate_points_axis_angle(points, rot_pred)
    rotated_gt = rotate_points_axis_angle(points, rot_gt)

    per_anchor = torch.mean(torch.linalg.norm(rotated_pred - rotated_gt, dim=-1), dim=-1)  # (B, P)
    if symmetric:  # every anchor's minimum distance, then the select (JAX's fixed shape)
        d2 = min_squared_distance(rotated_pred.flatten(0, 1), rotated_gt.flatten(0, 1))
        min_d = torch.sqrt(torch.clamp(d2, min=1e-12)).view(per_anchor.shape + (-1,))
        per_anchor = torch.where(is_sym, torch.mean(min_d, dim=-1), per_anchor)

    validf = valid.to(torch.float32)
    capped_pos = torch.clamp(torch.sum(validf, dim=1), min=1.0)
    rotation_loss = torch.sum(per_anchor * validf, dim=1) / capped_pos
    zero = torch.zeros_like(rotation_loss)
    rotation_loss = torch.where(num_pos > 0, rotation_loss, zero)

    trans_elem = _smooth_l1(trans_pred - trans_gt, sigma=1.0) * validf[..., None]
    translation_loss = torch.sum(trans_elem, dim=(1, 2)) / (capped_pos * 3.0)
    translation_loss = torch.where(num_pos > 0, translation_loss, zero)
    return rotation_loss, translation_loss


def total_loss(targets: AnchorTargets, classification, regression, rotation, translation, hand,
               model_3d_points, config: LossConfig = LossConfig(),
               symmetric: bool = True) -> LossBundle:
    """Batch loss with the reference's weighting; every prediction is (B, N, D),
    the per-image losses are averaged over the batch."""
    transformation_pred = torch.cat([rotation, translation], dim=-1)
    cls = focal_loss(targets.labels, classification, targets.state,
                     config.focal_alpha, config.focal_gamma).mean()
    reg = smooth_l1_loss(targets.regression, regression, targets.state, config.smooth_l1_sigma).mean()
    rot, trans = transformation_loss(targets.transformation, transformation_pred, targets.state,
                                     model_3d_points, config.max_positive_anchors, symmetric)
    rot, trans = rot.mean(), trans.mean()
    hnd = smooth_l1_loss(targets.coords_3d, hand, targets.state, config.smooth_l1_sigma).mean()

    cls_w = cls * config.classification_weight
    reg_w = reg * config.regression_weight
    rot_w = rot * config.rotation_weight
    trans_w = trans * config.translation_weight
    hand_w = hnd * config.hand_weight
    total = cls_w + reg_w + rot_w + trans_w + hand_w
    return LossBundle(cls_w, reg_w, rot_w, trans_w, hand_w, total)
