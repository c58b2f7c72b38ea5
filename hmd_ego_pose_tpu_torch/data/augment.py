"""Host augmentation: the 6-DoF image and pose warp, and the colour ops, in numpy.

Counterpart of ``hmd_ego_pose_tpu/data/augment.py``, for the host input
pipeline (``data/pipeline.py``: ``device_augment=False``).  Every random value
comes from the ``np.random.RandomState`` the caller passes, in the JAX
package's order, so for the same seed both packages draw the same numbers
and compute the same images and labels:

* ``augment_6dof``: in-plane rotation about the principal point and scale,
  applied to the image (bilinear warp), the mask (nearest warp), the
  rotation (a camera-Z rotation composed in), the translation (rotated, Tz
  divided by the scale), the hand joints (rotated, z divided by the scale)
  and each object's bbox (from the warped mask at its ``mask_values``
  pixel value); the rows of objects whose mask left the frame are dropped,
  and when none is left the input comes back with ``False``;
* ``random_6dof_params`` and ``ColorAugmenter`` (RandAugment-style: one or
  two of the 14 colour ops, magnitude 1..13).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from hmd_ego_pose_tpu_torch.data.colibri import get_bbox_from_mask, project_origin_2d
from hmd_ego_pose_tpu_torch.data.image import get_rotation_matrix_2d, warp_affine
from hmd_ego_pose_tpu_torch.ops.geometry import matrix_to_axis_angle, np_axis_angle_to_matrix


# ---------------------------------------------------------------------------
# 6-DoF augmentation
# ---------------------------------------------------------------------------


def augment_6dof(
    image: np.ndarray,
    mask: np.ndarray,
    annotations: Dict[str, np.ndarray],
    camera_matrix: np.ndarray,
    angle_deg: float,
    scale: float,
    mask_values: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Dict[str, np.ndarray], bool]:
    """Rotate/scale the image about the principal point and update all labels.

    Returns (augmented_image, augmented_annotations, is_valid).  Invalid when
    every object's mask is warped out of frame — the caller should then keep
    the original sample (colibri_common.py:426-431).
    """
    cx, cy = camera_matrix[0, 2], camera_matrix[1, 2]
    h, w = image.shape[:2]
    num = annotations["labels"].shape[0]
    if mask_values is None:
        mask_values = np.full((num,), 255, np.uint8)

    # NOTE: the reference passes -angle to cv2.getRotationMatrix2D and then
    # composes a +angle camera-Z rotation into the pose (colibri_common.py:467-500).
    rot2d = get_rotation_matrix_2d((cx, cy), -angle_deg, scale)
    aug_image = warp_affine(image, rot2d, (w, h), "bilinear")
    mask_gray = mask[..., 0] if mask.ndim == 3 else mask
    aug_mask = warp_affine(mask_gray, rot2d, (w, h), "nearest")

    _, any_valid = get_bbox_from_mask(aug_mask)
    if not any_valid:
        return image, annotations, False

    rz = np.zeros(3)
    rz[2] = math.radians(angle_deg)
    rot_z = np_axis_angle_to_matrix(rz)

    out = {k: v.copy() for k, v in annotations.items()}
    still_valid = np.ones((num,), bool)
    for i in range(num):
        bbox, ok = get_bbox_from_mask(aug_mask, int(mask_values[i]))
        if not ok:
            still_valid[i] = False
            continue

        r_obj = np_axis_angle_to_matrix(annotations["rotations"][i, :3])
        new_rot = matrix_to_axis_angle(rot_z @ r_obj)

        t = annotations["translations"][i].copy()
        new_t = t @ rot_z.T
        new_t[2] /= scale

        coords = annotations["coords_3d"][i]  # (21, 3)
        new_coords = coords @ rot_z.T
        new_coords[:, 2] /= scale

        out["bboxes"][i] = bbox
        out["rotations"][i, :3] = new_rot
        out["translations"][i] = new_t
        out["translations_x_y_2D"][i] = project_origin_2d(new_rot, new_t, camera_matrix)
        out["coords_3d"][i] = new_coords

    if not np.all(still_valid):
        keep = np.where(still_valid)[0]
        for k in out:
            out[k] = out[k][keep]

    return aug_image, out, True


def random_6dof_params(rng: np.random.RandomState, scale_range=(0.7, 1.3)):
    scale = rng.random_sample() * (scale_range[1] - scale_range[0]) + scale_range[0]
    angle = rng.random_sample() * 360.0
    return angle, scale


# ---------------------------------------------------------------------------
# Colorspace augmentation (RandAugment-style, numpy)
# ---------------------------------------------------------------------------


def _blend(a, b, factor):
    return np.clip(a.astype(np.float32) + (b.astype(np.float32) - a.astype(np.float32)) * factor, 0, 255).astype(np.uint8)


def _grayscale(img):
    return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]).astype(np.uint8)


def op_autocontrast(img, _m, _rng):
    out = np.empty_like(img)
    for c in range(3):
        ch = img[..., c]
        lo, hi = int(ch.min()), int(ch.max())
        if hi <= lo:
            out[..., c] = ch
        else:
            out[..., c] = ((ch.astype(np.float32) - lo) * (255.0 / (hi - lo))).astype(np.uint8)
    return out


def op_equalize(img, _m, _rng):
    out = np.empty_like(img)
    for c in range(3):
        ch = img[..., c]
        hist = np.bincount(ch.ravel(), minlength=256)
        cdf = hist.cumsum()
        nz = cdf[cdf > 0]
        if nz.size == 0:
            out[..., c] = ch
            continue
        cdf_min = nz[0]
        denom = cdf[-1] - cdf_min
        if denom == 0:
            out[..., c] = ch
            continue
        lut = np.round((cdf - cdf_min) * 255.0 / denom).clip(0, 255).astype(np.uint8)
        out[..., c] = lut[ch]
    return out


def op_invert(img, _m, _rng):
    return 255 - img


def op_posterize(img, m, _rng):
    bits = max(1, 8 - int(m * 4 / 14))
    shift = 8 - bits
    return ((img >> shift) << shift).astype(np.uint8)


def op_solarize(img, m, _rng):
    threshold = 256 - int(m * 256 / 14)
    return np.where(img < threshold, img, 255 - img).astype(np.uint8)


def op_color(img, m, rng):
    factor = 0.1 + m * 1.8 / 14 * rng.random_sample()
    gray = np.repeat(_grayscale(img)[..., None], 3, axis=-1)
    return _blend(gray, img, factor)


def op_contrast(img, m, rng):
    factor = 0.1 + m * 1.8 / 14 * rng.random_sample()
    mean = np.full_like(img, int(_grayscale(img).mean()))
    return _blend(mean, img, factor)


def op_brightness(img, m, rng):
    factor = 0.1 + m * 1.8 / 14 * rng.random_sample()
    return _blend(np.zeros_like(img), img, factor)


def op_sharpness(img, m, rng):
    factor = 0.1 + m * 1.8 / 14 * rng.random_sample()
    # 3x3 smoothing kernel as PIL's SMOOTH
    k = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0
    blurred = _conv3x3(img, k)
    return _blend(blurred, img, factor)


def op_cutout(img, m, rng):
    h, w = img.shape[:2]
    size = int(min(h, w) * (0.1 + 0.3 * m / 14))
    if size == 0:
        return img
    y = rng.randint(0, h)
    x = rng.randint(0, w)
    out = img.copy()
    out[max(0, y - size // 2): y + size // 2, max(0, x - size // 2): x + size // 2] = 127
    return out


def op_gaussian_noise(img, m, rng):
    sigma = m / 14 * 25.0
    noise = rng.normal(0, sigma, img.shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def op_blur(img, _m, _rng):
    k = np.ones((3, 3), np.float32) / 9.0
    return _conv3x3(img, k)


def op_smooth(img, _m, _rng):
    """PIL ImageFilter.SMOOTH 3x3 kernel (pillike.FilterSmooth, randaug.py:277)."""
    k = np.asarray([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0
    return _conv3x3(img, k)


def op_identity(img, _m, _rng):
    """meta.Identity (randaug.py:245): a real member of the op distribution."""
    return img


def _conv3x3(img, kernel):
    pad = np.pad(img.astype(np.float32), ((1, 1), (1, 1), (0, 0)), mode="edge")
    out = np.zeros_like(img, np.float32)
    for dy in range(3):
        for dx in range(3):
            out += kernel[dy, dx] * pad[dy: dy + img.shape[0], dx: dx + img.shape[1]]
    return np.clip(out, 0, 255).astype(np.uint8)


COLOR_OPS = (
    op_autocontrast,
    op_equalize,
    op_invert,
    op_posterize,
    op_solarize,
    op_color,
    op_contrast,
    op_brightness,
    op_sharpness,
    op_cutout,
    op_gaussian_noise,
    op_blur,
    op_smooth,
    op_identity,
)


class ColorAugmenter:
    """Apply n random colorspace ops with random magnitude (randaug.py)."""

    def __init__(self, n_range=(1, 3), magnitude_range=(1, 14)):
        self.n_range = n_range
        self.magnitude_range = magnitude_range

    def __call__(self, image: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        n = rng.randint(self.n_range[0], self.n_range[1])
        for _ in range(n):
            op = COLOR_OPS[rng.randint(0, len(COLOR_OPS))]
            m = rng.randint(self.magnitude_range[0], self.magnitude_range[1])
            image = op(image, m, rng)
        return image
