"""Host image I/O and preprocessing without PIL.

The JAX package reads and writes frames with PIL
(``hmd_ego_pose_tpu/data/image.py``); the port must not need PIL, so it
carries a PNG codec on the standard library's zlib for the formats its
datasets, golden frames and tools use: 8-bit grayscale, RGB or RGBA,
non-interlaced, any of the five PNG row filters on reading.  Anything else
raises.  ``write_png`` writes filter type 0 only, so the port's own files
decode on the vectorised path.

``resize_bilinear`` and ``preprocess_image`` are the host preprocess of the
JAX evaluator (its float64 numpy path, which its native uint8 path matches
bit for bit).

``get_rotation_matrix_2d`` and ``warp_affine`` are the host augmentation's
warp (cv2.getRotationMatrix2D and cv2.warpAffine: inverse sampling, bilinear
or nearest, zero border), as ``hmd_ego_pose_tpu/data/image.py`` has them: a
uint8 image goes through the compiled copy of the JAX package's C++ warp
(``data/native_warp.py``), anything else, or every image where no C++
compiler is found, through the numpy version.  The two differ where a
coordinate lands on a rounding tie: the C++ nearest warp rounds half away
from zero (``lround``) where numpy rounds half to even, and the compiler may
contract the coordinate's multiply-add.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Tuple

import numpy as np

from hmd_ego_pose_tpu_torch.data import native_warp
from hmd_ego_pose_tpu_torch.ops import preprocess

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels (gray, RGB, RGBA)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters -> (height, stride) uint8."""
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += stride + 1
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum along the row, per byte lane
            cur = line.reshape(-1, bpp).cumsum(axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = np.zeros(stride, np.int32)
            lv, up = line.tolist(), prev.tolist()
            row = [0] * stride
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[i] = (lv[i] + pred) & 0xFF
            cur = np.asarray(row, np.int32)
        else:
            raise ValueError(f"bad PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """8-bit gray, RGB or RGBA non-interlaced PNG -> uint8 (H, W, 3) RGB.

    Gray is replicated to the three channels and alpha dropped, as PIL's
    ``convert("RGB")`` does.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _comp, _filt, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit gray/RGB/RGBA non-interlaced PNGs are supported "
            f"(depth {depth}, colour type {colour}, interlace {interlace})"
        )
    channels = _CHANNELS[colour]
    raw = zlib.decompress(b"".join(idat))
    pixels = _unfilter(raw, height, width * channels, channels).reshape(height, width, channels)
    if channels == 1:
        return np.ascontiguousarray(np.repeat(pixels, 3, axis=2))
    return np.ascontiguousarray(pixels[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, image: np.ndarray) -> None:
    """uint8 (H, W) gray or (H, W, 3) RGB -> 8-bit non-interlaced PNG, filter type 0."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or not (image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError(f"write_png takes uint8 (H, W) or (H, W, 3), got {image.dtype} {image.shape}")
    height, width = image.shape[:2]
    colour = 0 if image.ndim == 2 else 2
    rows = np.ascontiguousarray(image).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6))
                + _chunk(b"IEND", b""))


def get_rotation_matrix_2d(center: Tuple[float, float], angle_deg: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3) float64 forward affine, angle in
    degrees, counter-clockwise positive, about ``center``."""
    a = math.radians(angle_deg)
    alpha = scale * math.cos(a)
    beta = scale * math.sin(a)
    cx, cy = center
    return np.array(
        [
            [alpha, beta, (1 - alpha) * cx - beta * cy],
            [-beta, alpha, beta * cx + (1 - alpha) * cy],
        ],
        dtype=np.float64,
    )


def _invert_affine(m: np.ndarray) -> np.ndarray:
    a = m[:, :2]
    t = m[:, 2]
    inv_a = np.linalg.inv(a)
    inv_t = -inv_a @ t
    return np.concatenate([inv_a, inv_t[:, None]], axis=1)


def warp_affine(image: np.ndarray, matrix: np.ndarray, out_size: Tuple[int, int],
                interpolation: str = "bilinear") -> np.ndarray:
    """Apply a forward (2, 3) affine to an (H, W) or (H, W, C) image
    (cv2.warpAffine): ``out_size`` is (width, height), ``interpolation``
    'bilinear' or 'nearest', zero outside the source."""
    w, h = out_size
    inv = _invert_affine(matrix)
    if np.issubdtype(image.dtype, np.uint8):
        native = native_warp.warp_affine_u8(image, inv, out_size, interpolation)
        if native is not None:
            return native

    ys, xs = np.mgrid[0:h, 0:w]
    src_x = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    src_y = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]

    squeeze = image.ndim == 2
    img = image[:, :, None] if squeeze else image
    ih, iw = img.shape[:2]

    if interpolation == "nearest":
        xi = np.round(src_x).astype(np.int64)
        yi = np.round(src_y).astype(np.int64)
        valid = (xi >= 0) & (xi < iw) & (yi >= 0) & (yi < ih)
        xi, yi = np.clip(xi, 0, iw - 1), np.clip(yi, 0, ih - 1)
        out = img[yi, xi].astype(img.dtype)
        out[~valid] = 0
    else:
        x0 = np.floor(src_x).astype(np.int64)
        y0 = np.floor(src_y).astype(np.int64)
        fx = (src_x - x0)[..., None]
        fy = (src_y - y0)[..., None]

        def sample(yy, xx):
            inside = (xx >= 0) & (xx < iw) & (yy >= 0) & (yy < ih)
            s = img[np.clip(yy, 0, ih - 1), np.clip(xx, 0, iw - 1)].astype(np.float64)
            s[~inside] = 0
            return s

        v00 = sample(y0, x0)
        v01 = sample(y0, x0 + 1)
        v10 = sample(y0 + 1, x0)
        v11 = sample(y0 + 1, x0 + 1)
        out = (
            v00 * (1 - fx) * (1 - fy)
            + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy
            + v11 * fx * fy
        )
        if np.issubdtype(image.dtype, np.integer):
            out = np.round(out).clip(np.iinfo(image.dtype).min, np.iinfo(image.dtype).max)
        out = out.astype(image.dtype)

    return out[:, :, 0] if squeeze else out


def resize_bilinear(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize with half-pixel centres (cv2 INTER_LINEAR), in float64."""
    oh, ow = out_hw
    ih, iw = image.shape[:2]
    if (oh, ow) == (ih, iw):
        return image.copy()
    ys = (np.arange(oh) + 0.5) * ih / oh - 0.5
    xs = (np.arange(ow) + 0.5) * iw / ow - 0.5
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    y0c, y1c = np.clip(y0, 0, ih - 1), np.clip(y0 + 1, 0, ih - 1)
    x0c, x1c = np.clip(x0, 0, iw - 1), np.clip(x0 + 1, 0, iw - 1)

    squeeze = image.ndim == 2
    img = image[:, :, None].astype(np.float64) if squeeze else image.astype(np.float64)
    v00 = img[y0c][:, x0c]
    v01 = img[y0c][:, x1c]
    v10 = img[y1c][:, x0c]
    v11 = img[y1c][:, x1c]
    out = v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx + v10 * fy * (1 - fx) + v11 * fy * fx
    if np.issubdtype(image.dtype, np.integer):
        out = np.round(out).clip(np.iinfo(image.dtype).min, np.iinfo(image.dtype).max)
    out = out.astype(image.dtype)
    return out[:, :, 0] if squeeze else out


IMAGENET_MEAN = np.array(preprocess.IMAGENET_MEAN, np.float32)
IMAGENET_STD = np.array(preprocess.IMAGENET_STD, np.float32)


def preprocess_image(image: np.ndarray, target_size: int) -> Tuple[np.ndarray, float]:
    """Aspect-preserving resize + /255 + ImageNet norm + bottom/right zero pad.

    Returns the float32 (target, target, 3) image and the applied scale.
    """
    h, w = image.shape[:2]
    scale = target_size / (h if h > w else w)
    rh, rw = preprocess.resized_shape(h, w, target_size)
    image = resize_bilinear(image, (rh, rw)).astype(np.float32)
    image /= 255.0
    image -= IMAGENET_MEAN
    image /= IMAGENET_STD
    out = np.zeros((target_size, target_size, 3), np.float32)
    out[:rh, :rw] = image
    return out, scale
