"""Device-side image preprocessing: uint8 frames -> normalized NHWC float32.

Counterpart of ``hmd_ego_pose_tpu/ops/preprocess.py``: aspect-preserving
cv2-style bilinear resize (half-pixel centres, no antialiasing), rounded to
uint8 levels before the /255, ImageNet normalization and bottom/right zero
pad.

The JAX package resizes with two dense matmuls against interpolation
matrices, and XLA rewrites the normalization.  Every output of those matmuls
is a two-tap sum (the other taps are exact zeros), so the port computes each
pass as an explicit gather of the two source rows (or columns) and a lerp,
rounded as XLA:CPU rounds the jitted JAX function:

* a pass whose output length ``n`` has ``(n - 1) % 64 >= 48`` (every pass to
  256) runs XLA's fused kernel: ``fma(w1, x1, w0 * x0)``; any other pass
  rounds both products and their sum (``w0 * x0 + w1 * x1``).  This is the
  kernel choice of XLA:CPU's dot as jax 0.9 makes it for these shapes (large
  contraction lengths, above ~1000, split the sum in blocks and differ);
* the normalization is ``fma(x, 1/255, -mean) * (1/std)``, the reciprocals
  rounded to float32, as XLA folds the two divisions.

An FMA is computed exactly in float64: the product of two float32 is exact
there, and the sum is rounded to odd before the one rounding to float32.
Only IEEE float64 adds and multiplies are used, so the card and the CPU give
the same bits.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _taps(out_size: int, in_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(i0, i1, w0, w1): the two source indices and float32 weights of each output,
    cv2 half-pixel convention; a clamped edge has one tap (w1 = 0), whose weight
    is the float32 sum the interpolation matrix holds there."""
    coords = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
    i0 = np.floor(coords).astype(np.int64)
    frac = coords - i0
    a = np.clip(i0, 0, in_size - 1)
    b = np.clip(i0 + 1, 0, in_size - 1)
    w0 = (1.0 - frac).astype(np.float32)
    w1 = frac.astype(np.float32)
    edge = a == b
    w0[edge] = (w0[edge] + frac[edge]).astype(np.float32)
    w1[edge] = 0.0
    return a, b, w0, w1


@functools.lru_cache(maxsize=16)
def _taps_tensor(out_size: int, in_size: int, device: torch.device):
    a, b, w0, w1 = _taps(out_size, in_size)
    return tuple(torch.from_numpy(v).to(device) for v in (a, b, w0, w1))


@functools.lru_cache(maxsize=16)
def _normalization(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(1/255, -mean, 1/std) on ``device``, uploaded once per device: an upload
    inside a preprocess that a CUDA graph captures would be illegal."""
    inv255 = torch.tensor(np.float32(1.0) / np.float32(255.0), device=device)
    neg_mean = torch.tensor([-m for m in IMAGENET_MEAN], dtype=torch.float32, device=device)
    inv_std = torch.tensor(np.float32(1.0) / np.asarray(IMAGENET_STD, np.float32), device=device)
    return inv255, neg_mean, inv_std


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with a single rounding, from float64 operations only."""
    p = a.double() * b.double()  # exact: 24 + 24 bits
    c = c.double()
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)  # s + err == p + c exactly (TwoSum)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, np.inf), torch.full_like(s, -np.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)  # round to odd
    return s.float()


def _lerp_pass(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    """Resize ``x`` (float32, integral or not) along ``dim`` to ``out_size``."""
    a, b, w0, w1 = _taps_tensor(out_size, x.shape[dim], x.device)
    shape = [1] * x.dim()
    shape[dim] = out_size
    w0, w1 = w0.reshape(shape), w1.reshape(shape)
    p0 = x.index_select(dim, a) * w0
    x1 = x.index_select(dim, b)
    if (out_size - 1) % 64 >= 48:
        return _fma(w1.expand_as(x1), x1, p0)
    return p0 + x1 * w1


def resized_shape(h: int, w: int, target_size: int):
    if h > w:
        return target_size, int(w * (target_size / h))
    return int(h * (target_size / w)), target_size


def preprocess_uint8_batch(frames: torch.Tensor, target_size: int) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalized float32 (B, S, S, 3), aspect-preserving."""
    b, h, w, c = frames.shape
    rh, rw = resized_shape(h, w, target_size)
    x = frames.to(torch.float32)
    if (rh, rw) != (h, w):
        x = torch.round(_lerp_pass(_lerp_pass(x, rh, 1), rw, 2))
    inv255, neg_mean, inv_std = _normalization(frames.device)
    x = _fma(x, inv255.expand_as(x), neg_mean.expand_as(x)) * inv_std
    if rh != target_size or rw != target_size:
        x = torch.nn.functional.pad(x, (0, 0, 0, target_size - rw, 0, target_size - rh))
    return x
