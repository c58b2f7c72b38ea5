"""The training augmentation, frozen here: RandAugment colour ops and the 6-DoF warp.

A copy of the formulas of the program's ``ops/augment_device.py`` (the
reference repository's augmentation as the port computes it: the same
uint8 truncation points, inverse-affine warp with a zero border, label
updates and fall back to the unaugmented frame when the object leaves
it), applied here row by row from the step's drawn values, so the
reference works each augmented batch out again from the raw frames.  It
imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_EPS = 1e-12


_EPS = 1e-12
NUM_OPS = 14
MAX_SLOTS = 2  # 1 or 2 active colour slots per example
IDENTITY = NUM_OPS - 1
(AUTOCONTRAST, EQUALIZE, INVERT, POSTERIZE, SOLARIZE, COLOR, CONTRAST, BRIGHTNESS,
 SHARPNESS, CUTOUT, GAUSSIAN_NOISE, BLUR, SMOOTH) = range(13)


# ---------------------------------------------------------------------------


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


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector: quaternion by
    Shepperd's method (4-way select), robust at angle ~ 0 and ~ pi."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    t0 = 1.0 + m00 + m11 + m22
    t1 = 1.0 + m00 - m11 - m22
    t2 = 1.0 - m00 + m11 - m22
    t3 = 1.0 - m00 - m11 + m22

    def root(t):
        return torch.sqrt(torch.clamp(t, min=_EPS)) * 2.0

    s0, s1, s2, s3 = root(t0), root(t1), root(t2), root(t3)
    cand0 = torch.stack([s0 / 4.0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], dim=-1)
    cand1 = torch.stack([(m21 - m12) / s1, s1 / 4.0, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1)
    cand2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, s2 / 4.0, (m12 + m21) / s2], dim=-1)
    cand3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, s3 / 4.0], dim=-1)
    best = torch.argmax(torch.stack([t0, t1, t2, t3], dim=-1), dim=-1)[..., None]
    q = torch.where(best == 0, cand0, torch.where(best == 1, cand1, torch.where(best == 2, cand2, cand3)))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    q = torch.where(q[..., 0:1] < 0, -q, q)  # w >= 0: angle in [0, pi]
    w, v = q[..., 0], q[..., 1:]
    n = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * torch.atan2(n, w)
    big = n > 1e-9
    scale = torch.where(big, angle / torch.where(big, n, torch.ones_like(n)), torch.full_like(n, 2.0))
    return v * scale[..., None]


# ---------------------------------------------------------------------------
# Affine warp (inverse map, zero border)
# ---------------------------------------------------------------------------


def inverse_affine(angle_deg: torch.Tensor, scale: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor
                   ) -> torch.Tensor:
    """(B,) angles, scales and centres -> (B, 2, 3) inverse of
    cv2.getRotationMatrix2D(centre, angle, scale)."""
    a = angle_deg * (math.pi / 180.0)
    alpha = scale * torch.cos(a)
    beta = scale * torch.sin(a)
    tx = (1.0 - alpha) * cx - beta * cy
    ty = beta * cx + (1.0 - alpha) * cy
    det = alpha * alpha + beta * beta
    ia, ib = alpha / det, beta / det
    itx = -(ia * tx + (-ib) * ty)
    ity = -(ib * tx + ia * ty)
    return torch.stack([torch.stack([ia, -ib, itx], dim=-1), torch.stack([ib, ia, ity], dim=-1)], dim=-2)


def _src_coords(inv: torch.Tensor, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 2, 3) -> source (y, x) of every output pixel, (B, H, W) each."""
    ys = torch.arange(h, device=inv.device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=inv.device, dtype=torch.float32)[None, None, :]
    c = inv[:, :, :, None, None]
    src_x = c[:, 0, 0] * xs + c[:, 0, 1] * ys + c[:, 0, 2]
    src_y = c[:, 1, 0] * xs + c[:, 1, 1] * ys + c[:, 1, 2]
    return src_y, src_x


def _taps(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C) at integer (B, H', W') taps, 0 outside the image -> (B, H', W', C)."""
    b, h, w, c = img.shape
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    flat = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(b, -1, 1).expand(-1, -1, c)
    vals = torch.gather(img.reshape(b, h * w, c), 1, flat).reshape(b, *iy.shape[1:], c)
    return torch.where(valid[..., None], vals, torch.zeros_like(vals))


def warp_bilinear_u8(images: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> warped uint8: map_coordinates order 1, taps summed
    (y0 x0) + (y0 x1) + (y1 x0) + (y1 x1), rounded half to even."""
    _, h, w, _ = images.shape
    src_y, src_x = _src_coords(inv, h, w)
    img = images.to(torch.float32)
    ly, lx = torch.floor(src_y), torch.floor(src_x)
    wy1, wx1 = src_y - ly, src_x - lx
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy, ix = ly.to(torch.int64), lx.to(torch.int64)
    out = None
    for dy, wy in ((0, wy0), (1, wy1)):
        for dx, wx in ((0, wx0), (1, wx1)):
            term = (wy * wx)[..., None] * _taps(img, iy + dy, ix + dx)
            out = term if out is None else out + term
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    t = torch.trunc(x)
    return t + torch.where(torch.abs(x - t) >= 0.5, torch.sign(x), torch.zeros_like(x))


def warp_nearest_u8(masks: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 mask -> warped mask: map_coordinates order 0 (indices
    rounded half away from zero), zero border."""
    _, h, w = masks.shape
    src_y, src_x = _src_coords(inv, h, w)
    iy, ix = _round_half_away(src_y).to(torch.int64), _round_half_away(src_x).to(torch.int64)
    return _taps(masks[..., None], iy, ix)[..., 0]


def bbox_from_mask(sel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) bool -> ((B, 4) [x1, y1, x2, y2] float32 inclusive extrema, (B,) any)."""
    _, h, w = sel.shape
    any_row, any_col = sel.any(dim=2), sel.any(dim=1)
    ys = torch.arange(h, device=sel.device)
    xs = torch.arange(w, device=sel.device)
    y1 = torch.where(any_row, ys, h).amin(dim=1)
    y2 = torch.where(any_row, ys, -1).amax(dim=1)
    x1 = torch.where(any_col, xs, w).amin(dim=1)
    x2 = torch.where(any_col, xs, -1).amax(dim=1)
    valid = any_row.any(dim=1)
    bbox = torch.stack([x1, y1, x2, y2], dim=-1).to(torch.float32)
    return torch.where(valid[:, None], bbox, torch.zeros_like(bbox)), valid


# ---------------------------------------------------------------------------
# Colour ops on (M, H, W, 3) float32 images holding uint8 values
# ---------------------------------------------------------------------------
# Each takes its group's magnitudes m (M,) float32 and its drawn values.


def _u8(x):
    return torch.floor(torch.clamp(x, 0.0, 255.0))


def _grayscale(img):
    return torch.floor(0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])


def _blend(a, b, factor):
    return _u8(a + (b - a) * factor[:, None, None, None])


def _factor(m, r):
    return 0.1 + m * 1.8 / 14.0 * r


def op_autocontrast(img, m):
    lo = torch.floor(torch.amin(img, dim=(1, 2), keepdim=True))
    hi = torch.floor(torch.amax(img, dim=(1, 2), keepdim=True))
    span = torch.clamp(hi - lo, min=1.0)
    # 255 / span divided, as JAX does (a number over a tensor is reciprocal() * 255 in torch)
    stretched = torch.floor((img - lo) * (torch.full_like(span, 255.0) / span))
    return torch.where(hi <= lo, img, torch.clamp(stretched, 0, 255))


def op_equalize(img, m):
    mm, h, w, c = img.shape
    flat = img.to(torch.int64).permute(0, 3, 1, 2).reshape(mm, c, h * w)
    hist = torch.zeros((mm, c, 256), dtype=torch.int64, device=img.device)
    hist.scatter_add_(2, flat, torch.ones_like(flat))  # integer adds: exact in any order
    cdf = torch.cumsum(hist, dim=2)
    last = cdf[..., -1:]
    cdf_min = torch.where(hist > 0, cdf, last + 1).amin(dim=2, keepdim=True)
    denom = last - cdf_min
    lut = torch.clamp(torch.round((cdf - cdf_min).to(torch.float32) * 255.0
                                  / torch.clamp(denom, min=1).to(torch.float32)), 0, 255)
    out = torch.gather(lut, 2, flat).reshape(mm, c, h, w).permute(0, 2, 3, 1)
    return torch.where((denom == 0)[:, None, :, :].reshape(mm, 1, 1, c), img, out)


def op_invert(img, m):
    return 255.0 - img


def op_posterize(img, m):
    bits = torch.clamp(8 - torch.floor(m * 4.0 / 14.0).to(torch.int32), min=1)
    q = torch.exp2((8 - bits).to(torch.float32))[:, None, None, None]
    return torch.floor(img / q) * q


def op_solarize(img, m):
    threshold = (256.0 - torch.floor(m * 256.0 / 14.0))[:, None, None, None]
    return torch.where(img < threshold, img, 255.0 - img)


def op_color(img, m, r):
    gray = _grayscale(img)[..., None] * torch.ones(3, device=img.device)
    return _blend(gray, img, _factor(m, r))


def _mean_level(gray):
    """(M, H, W) integer grey levels -> (M,) float32 mean per row: the levels
    summed exactly in int64, then divided in float32 (a float32 sum is exact
    only up to 2**24 / 255 pixels, and its rounding would then depend on how
    the reduction splits the rows); the divisor a tensor, so the card divides
    as the CPU does instead of multiplying by a reciprocal."""
    total = gray.to(torch.int64).sum(dim=(1, 2)).to(torch.float32)
    return total / torch.full_like(total, float(gray.shape[1] * gray.shape[2]))


def op_contrast(img, m, r):
    mean = torch.floor(_mean_level(_grayscale(img)))
    return _blend(mean[:, None, None, None].expand_as(img), img, _factor(m, r))


def op_brightness(img, m, r):
    return _blend(torch.zeros_like(img), img, _factor(m, r))


def _conv3x3(img, kernel):
    """Edge-padded 3x3 filter as 9 shifted adds, in row-major tap order."""
    _, h, w, _ = img.shape
    pad = torch.nn.functional.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)
    out = torch.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            out = out + kernel[dy][dx] * pad[:, dy:dy + h, dx:dx + w, :]
    return _u8(out)


_SMOOTH_K = [[1 / 13.0] * 3, [1 / 13.0, 5 / 13.0, 1 / 13.0], [1 / 13.0] * 3]
_BLUR_K = [[1 / 9.0] * 3] * 3


def op_sharpness(img, m, r):
    return _blend(_conv3x3(img, _SMOOTH_K), img, _factor(m, r))


def op_cutout(img, m, yx):
    """``yx``: (M, 2) integer centres, drawn uniformly in [0, H) x [0, W)."""
    _, h, w, _ = img.shape
    size = torch.floor(min(h, w) * (0.1 + 0.3 * m / 14.0)).to(torch.int64)[:, None, None]
    y, x = yx[:, 0, None, None], yx[:, 1, None, None]
    half = torch.div(size, 2, rounding_mode="floor")
    ys = torch.arange(h, device=img.device)[None, :, None]
    xs = torch.arange(w, device=img.device)[None, None, :]
    box = ((ys >= torch.clamp(y - half, min=0)) & (ys < y + half)
           & (xs >= torch.clamp(x - half, min=0)) & (xs < x + half))
    out = torch.where(box[..., None], torch.full_like(img, 127.0), img)
    return torch.where((size == 0)[..., None], img, out)


def op_gaussian_noise(img, m, noise):
    """``noise``: (M, H, W, 3) standard normal draws."""
    sigma = (m / 14.0 * 25.0)[:, None, None, None]
    return _u8(img + noise * sigma)


def op_blur(img, m):
    return _conv3x3(img, _BLUR_K)


def op_smooth(img, m):
    return _conv3x3(img, _SMOOTH_K)


_FACTOR_OPS = {COLOR: op_color, CONTRAST: op_contrast, BRIGHTNESS: op_brightness, SHARPNESS: op_sharpness}
_PLAIN_OPS = {AUTOCONTRAST: op_autocontrast, EQUALIZE: op_equalize, INVERT: op_invert, POSTERIZE: op_posterize,
              SOLARIZE: op_solarize, BLUR: op_blur, SMOOTH: op_smooth}


def apply_op(op: int, img, m, r=None, yx=None, noise=None):
    """Colour op ``op`` (not the identity) on the rows ``img``, with their
    magnitudes ``m`` (M,) and, where the op takes them, factors ``r`` (M,),
    cutout centres ``yx`` (M, 2) or noise (M, H, W, 3)."""
    if op in _FACTOR_OPS:
        return _FACTOR_OPS[op](img, m, r)
    if op == CUTOUT:
        return op_cutout(img, m, yx)
    if op == GAUSSIAN_NOISE:
        return op_gaussian_noise(img, m, noise)
    return _PLAIN_OPS[op](img, m)


def colour_row(img: torch.Tensor, ops, magnitudes, factors, cutout_yx, noise) -> torch.Tensor:
    """One (H, W, 3) float32 frame through its slots' ops in order (``ops``
    per slot, the identity skipped); ``noise`` per slot, or None."""
    for slot, op in enumerate(ops):
        if op == IDENTITY:
            continue
        m = magnitudes[slot:slot + 1].float()
        r = factors[slot:slot + 1].float()
        yx = cutout_yx[slot:slot + 1]
        nz = None if noise[slot] is None else noise[slot][None].float()
        img = apply_op(op, img[None], m, r, yx, nz)[0]
    return img


def warp_6dof(image, mask, bbox, rotation, translation, coords, cx, cy, angle_deg, scale):
    """One frame and its object's labels, warped about the principal point:
    the image by -angle (bilinear), the mask (nearest), the pose composed
    with a +angle camera-Z rotation, Tz and the joints' z over the scale, the
    box from the warped mask; the inputs unchanged where the object left."""
    inv = inverse_affine(-angle_deg[None], scale[None], cx[None], cy[None])
    aug_image = warp_bilinear_u8(image[None], inv)[0]
    aug_mask = warp_nearest_u8(mask[None], inv)[0]
    new_box, ok = bbox_from_mask((aug_mask == 255)[None])
    if not bool(ok[0]):
        return image, bbox, rotation, translation, coords
    zero = torch.zeros_like(angle_deg)
    rz = axis_angle_to_matrix(torch.stack([zero, zero, angle_deg * (math.pi / 180.0)]))
    new_rot = matrix_to_axis_angle(rz @ axis_angle_to_matrix(rotation))
    new_t = rz @ translation
    new_t = torch.cat([new_t[:2], new_t[2:] / scale])
    new_c = coords @ rz.T
    new_c = torch.cat([new_c[:, :2], new_c[:, 2:] / scale], dim=1)
    return aug_image, new_box[0], new_rot, new_t, new_c

