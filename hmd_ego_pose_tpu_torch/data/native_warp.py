"""The host's uint8 affine warp, compiled from ``native/warp.cpp`` on first use.

The JAX package warps uint8 frames and masks for its host augmentation in
C++ (``native/frameio.cpp``, built with ``g++ -O3 -march=native``) and falls
back to numpy where it cannot build.  The port carries its own copy of the two
warp functions and builds them with the same compiler and flags into
``_build/warp-<hash>.so``, so on one host both packages compute the same bits;
the hash covers the source, the flags and this CPU's model and feature flags
(``-march=native`` code must not run on another CPU).  Without a C++ compiler
``warp_affine_u8`` returns None and the caller takes the numpy path, as the
JAX package does.

Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "warp.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_state = {"lib": None, "failed": False}


def _cpu_identity() -> bytes:
    """The CPU model and feature flags, as ``/proc/cpuinfo`` gives them."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    return b"\n".join(sorted({ln for ln in lines if ln.startswith((b"model name", b"flags"))}))


def library_path(compiler: str) -> str:
    h = hashlib.sha256(" ".join((compiler,) + FLAGS).encode() + b"\0" + _cpu_identity())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"warp-{h.hexdigest()[:16]}.so")


def _build(compiler: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out[:-3]}.{os.getpid()}.tmp.so"
    subprocess.run([compiler, *FLAGS, SOURCE, "-o", tmp], check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)


def library() -> Optional[ctypes.CDLL]:
    """The loaded warp library, built first if needed; None without a compiler
    or when the build fails."""
    with _lock:
        if _state["lib"] is not None or _state["failed"]:
            return _state["lib"]
        compiler = shutil.which("g++")
        if compiler is None:
            _state["failed"] = True
            return None
        out = library_path(compiler)
        try:
            if not os.path.exists(out):
                _build(compiler, out)
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.SubprocessError):
            _state["failed"] = True
            return None
        u8p, dp, i = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double), ctypes.c_int
        lib.warp_affine_bilinear_u8.argtypes = [u8p, i, i, i, dp, u8p, i, i, i]
        lib.warp_affine_bilinear_u8.restype = None
        lib.warp_affine_nearest_u8.argtypes = [u8p, i, i, i, dp, u8p, i, i]
        lib.warp_affine_nearest_u8.restype = None
        _state["lib"] = lib
        return lib


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
