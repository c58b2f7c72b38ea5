"""The host's uint8 affine warp, compiled from ``native/warp.cpp`` on first use.

The JAX package warps uint8 frames and masks for its host augmentation in
C++ (``native/frameio.cpp``, built with ``g++ -O3 -march=native``) and falls
back to numpy where it cannot build.  The port carries its own copy of the two
warp functions and builds them with the same compiler and flags
(``utils/native_build.py``) into ``_build/warp-<hash>.so``, so on one host
both packages compute the same bits.  Without a C++ compiler
``warp_affine_u8`` returns None and the caller takes the numpy path, as the
JAX package does.

Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from hmd_ego_pose_tpu_torch.utils import native_build

SOURCE = os.path.join(native_build.NATIVE_DIR, "warp.cpp")

_lock = threading.Lock()
_state = {"lib": None, "failed": False}


def _declare(lib: ctypes.CDLL) -> None:
    u8p, dp, i = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double), ctypes.c_int
    lib.warp_affine_bilinear_u8.argtypes = [u8p, i, i, i, dp, u8p, i, i, i]
    lib.warp_affine_bilinear_u8.restype = None
    lib.warp_affine_nearest_u8.argtypes = [u8p, i, i, i, dp, u8p, i, i]
    lib.warp_affine_nearest_u8.restype = None


def library() -> Optional[ctypes.CDLL]:
    """The loaded warp library, built first if needed; None without a compiler
    or when the build fails."""
    return native_build.load("warp", SOURCE, _state, _lock, _declare)


def warp_affine_u8(image: np.ndarray, inv_matrix: np.ndarray, out_size: Tuple[int, int],
                   interpolation: str) -> Optional[np.ndarray]:
    """Warp a uint8 (H, W) or (H, W, C) image by the INVERSE (dst -> src) 2x3
    affine ``inv_matrix`` into ``out_size`` = (width, height), zero border.
    None when the library is unavailable."""
    lib = library()
    if lib is None or image.dtype != np.uint8:
        return None
    squeeze = image.ndim == 2
    img = np.ascontiguousarray(image[:, :, None] if squeeze else image)
    h, w, c = img.shape
    ow, oh = out_size
    out = np.empty((oh, ow, c), np.uint8)
    m = np.ascontiguousarray(np.asarray(inv_matrix, np.float64).reshape(6))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    src_p, dst_p = img.ctypes.data_as(u8p), out.ctypes.data_as(u8p)
    mp = m.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    if interpolation == "nearest":
        lib.warp_affine_nearest_u8(src_p, h, w, c, mp, dst_p, oh, ow)
    else:
        lib.warp_affine_bilinear_u8(src_p, h, w, c, mp, dst_p, oh, ow, 0)
    return out[:, :, 0] if squeeze else out
