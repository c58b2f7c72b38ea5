"""Anchor decode: boxes, translation (pinhole back-projection) and hands.

Counterpart of ``hmd_ego_pose_tpu/ops/decode.py``; elementwise over the
anchor dimension, the same operations in the same order.
"""

from __future__ import annotations

import torch


def bbox_transform_inv(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """(ty, tx, th, tw) deltas on (x1, y1, x2, y2) anchors -> boxes."""
    cxa = (anchors[..., 0] + anchors[..., 2]) / 2
    cya = (anchors[..., 1] + anchors[..., 3]) / 2
    wa = anchors[..., 2] - anchors[..., 0]
    ha = anchors[..., 3] - anchors[..., 1]
    ty, tx, th, tw = deltas[..., 0], deltas[..., 1], deltas[..., 2], deltas[..., 3]
    w = torch.exp(tw) * wa
    h = torch.exp(th) * ha
    cy = ty * ha + cya
    cx = tx * wa + cxa
    return torch.stack([cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0], dim=-1)


def clip_boxes(boxes: torch.Tensor, height: int, width: int) -> torch.Tensor:
    x1 = boxes[..., 0].clamp(0, width - 1)
    y1 = boxes[..., 1].clamp(0, height - 1)
    x2 = boxes[..., 2].clamp(0, width - 1)
    y2 = boxes[..., 3].clamp(0, height - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def translation_transform_inv(translation_anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """(dx, dy, Tz) on (x, y, stride) anchors -> (x_2d, y_2d, Tz)."""
    stride = translation_anchors[..., -1]
    x = translation_anchors[..., 0] + deltas[..., 0] * stride
    y = translation_anchors[..., 1] + deltas[..., 1] * stride
    return torch.stack([x, y, deltas[..., 2]], dim=-1)


def calculate_txty(xy_tz: torch.Tensor, camera_parameters: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) of (x_2d, y_2d, Tz_raw) with (B, 6) [fx, fy, px, py, tz_scale,
    image_scale] -> (B, N, 3) metric translation (mm when tz_scale is 1000)."""
    fx = camera_parameters[:, 0:1]
    fy = camera_parameters[:, 1:2]
    px = camera_parameters[:, 2:3]
    py = camera_parameters[:, 3:4]
    tz_scale = camera_parameters[:, 4:5]
    image_scale = camera_parameters[:, 5:6]
    x = xy_tz[..., 0] / image_scale - px
    y = xy_tz[..., 1] / image_scale - py
    tz = xy_tz[..., 2] * tz_scale
    tx = x * tz / fx
    ty = y * tz / fy
    return torch.stack([tx, ty, tz], dim=-1)


def decode_translation(translation_anchors, translation_raw, camera_parameters):
    return calculate_txty(translation_transform_inv(translation_anchors, translation_raw),
                          camera_parameters)


def hand_to_relative(coords_3d: torch.Tensor, translation_mm: torch.Tensor) -> torch.Tensor:
    """Subtract the object translation (mm -> m) from each of the 21 joints (training targets)."""
    return coords_3d - (translation_mm / 1000.0).repeat(*(1,) * (translation_mm.dim() - 1), 21)


def hand_to_absolute(coords_3d_rel: torch.Tensor, translation_mm: torch.Tensor) -> torch.Tensor:
    """Add the object translation (mm -> m) to each of the 21 joints."""
    return coords_3d_rel + (translation_mm / 1000.0).repeat(*(1,) * (translation_mm.dim() - 1), 21)
