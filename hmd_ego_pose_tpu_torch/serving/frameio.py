"""Host frame ingest: I420 / NV12 to RGB8, and a frame ring.

Counterpart of ``hmd_ego_pose_tpu/serving/frameio.py``.  The HMD's video
arrives as NV12 (the reference's HoloLens sandbox) or I420; the server turns
each frame into RGB8 on the host before it goes to the engine.  The
conversions and the ring are C++ (``native/frameio.cpp``, a copy of the JAX
package's functions) built with ``g++ -O3 -march=native`` into
``_build/frameio-<hash>.so`` on first use (``utils/native_build.py``), so
on one host both packages decode the same bits.  Without a C++ compiler the
conversions take the JAX package's numpy copies and ``FrameRing`` a
``deque``, as the JAX package does.

``CONVERSIONS`` counts the conversions by the path they took (``"native"``,
``"numpy"``), so a run can show which one it went through.

Both formats subsample chroma 2x2, so height and width must be even.  Here
the JAX package reads past the end of its chroma planes (C++) or raises from
a reshape (numpy); the port refuses odd sizes with ``ValueError``.

Nothing is built when the module is imported.
"""

from __future__ import annotations

import collections
import ctypes
import os
import threading
from typing import Optional

import numpy as np

from hmd_ego_pose_tpu_torch.kernels import LaunchCounts
from hmd_ego_pose_tpu_torch.utils import native_build

SOURCE = os.path.join(native_build.NATIVE_DIR, "frameio.cpp")

CONVERSIONS = LaunchCounts()

_lock = threading.Lock()
_state = {"lib": None, "failed": False}


def _declare(lib: ctypes.CDLL) -> None:
    u8p, i, i64, vp = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    lib.i420_to_rgb.argtypes = [u8p, u8p, u8p, i, i, i, i, u8p]
    lib.i420_to_rgb.restype = None
    lib.nv12_to_rgb.argtypes = [u8p, u8p, i, i, i, i, u8p]
    lib.nv12_to_rgb.restype = None
    lib.ring_create.argtypes = [i64, i64]
    lib.ring_create.restype = vp
    lib.ring_destroy.argtypes = [vp]
    lib.ring_destroy.restype = None
    lib.ring_push.argtypes = [vp, u8p]
    lib.ring_push.restype = i
    lib.ring_pop.argtypes = [vp, u8p, i64]
    lib.ring_pop.restype = i64
    lib.ring_size.argtypes = [vp]
    lib.ring_size.restype = i64


def library() -> Optional[ctypes.CDLL]:
    """The loaded frame-ingest library, built first if needed; None without a
    compiler or when the build fails."""
    return native_build.load("frameio", SOURCE, _state, _lock, _declare)


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def yuv420_size(height: int, width: int) -> int:
    """Bytes of one I420 or NV12 frame; raises unless both sizes are even and >= 0."""
    if height < 0 or width < 0 or height % 2 or width % 2:
        raise ValueError(f"I420 and NV12 frames need even, non-negative height and width, got {height}x{width}")
    return height * width * 3 // 2


def _payload(payload: np.ndarray, height: int, width: int) -> np.ndarray:
    """The payload as flat contiguous uint8 of exactly one frame's size."""
    size = yuv420_size(height, width)
    flat = np.ascontiguousarray(payload).reshape(-1)
    if flat.dtype != np.uint8 or flat.size != size:
        raise ValueError(f"a {height}x{width} YUV 4:2:0 frame is {size} uint8 bytes, "
                         f"got {flat.size} of {flat.dtype}")
    return flat


def _i420_numpy(y: np.ndarray, u: np.ndarray, v: np.ndarray, height: int, width: int) -> np.ndarray:
    """The JAX package's numpy fallback, step for step."""
    yf = y.reshape(height, width).astype(np.int32)
    uf = u.reshape(height // 2, width // 2).astype(np.int32)
    vf = v.reshape(height // 2, width // 2).astype(np.int32)
    uf = np.repeat(np.repeat(uf, 2, 0), 2, 1)[:height, :width]
    vf = np.repeat(np.repeat(vf, 2, 0), 2, 1)[:height, :width]
    c = yf - 16
    d = uf - 128
    e = vf - 128
    r = (298 * c + 409 * e + 128) >> 8
    g = (298 * c - 100 * d - 208 * e + 128) >> 8
    b = (298 * c + 516 * d + 128) >> 8
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def i420_to_rgb(payload: np.ndarray, height: int, width: int) -> np.ndarray:
    """Planar I420 bytes (Y, then U and V at half size) -> RGB8 (H, W, 3);
    BT.601 limited range."""
    flat = _payload(payload, height, width)
    y_size = height * width
    uv_size = y_size // 4
    y = flat[:y_size]
    u = flat[y_size: y_size + uv_size]
    v = flat[y_size + uv_size:]
    lib = library()
    if lib is None:
        CONVERSIONS.add("numpy")
        return _i420_numpy(y, u, v, height, width)
    out = np.empty((height, width, 3), np.uint8)
    lib.i420_to_rgb(_u8ptr(y), _u8ptr(u), _u8ptr(v), height, width, width, width // 2, _u8ptr(out))
    CONVERSIONS.add("native")
    return out


def nv12_to_rgb(payload: np.ndarray, height: int, width: int) -> np.ndarray:
    """Semi-planar NV12 bytes (Y plane, then interleaved U, V at half size) ->
    RGB8 (H, W, 3); BT.601 limited range."""
    flat = _payload(payload, height, width)
    y_size = height * width
    y = flat[:y_size]
    uv = flat[y_size:]
    lib = library()
    if lib is None:
        # the JAX package's fallback: de-interleave UV, then the I420 arithmetic
        CONVERSIONS.add("numpy")
        uv2 = uv.reshape(-1, 2)
        return _i420_numpy(y, np.ascontiguousarray(uv2[:, 0]), np.ascontiguousarray(uv2[:, 1]), height, width)
    out = np.empty((height, width, 3), np.uint8)
    lib.nv12_to_rgb(_u8ptr(y), _u8ptr(uv), height, width, width, width, _u8ptr(out))
    CONVERSIONS.add("native")
    return out


class FrameRing:
    """Single-producer single-consumer ring of fixed-size frames; when full, a
    push drops the oldest frame.  The native ring, or a ``deque`` without the
    library."""

    def __init__(self, frame_bytes: int, capacity: int = 64):
        if frame_bytes <= 0 or capacity <= 0:
            raise ValueError(f"frame_bytes and capacity must be positive, got {frame_bytes}, {capacity}")
        self.frame_bytes = frame_bytes
        self.capacity = capacity
        self._lib = library()
        self._handle = self._lib.ring_create(frame_bytes, capacity) if self._lib is not None else None
        if not self._handle:
            self._lib = None
            self._deque: "collections.deque[np.ndarray]" = collections.deque(maxlen=capacity)
            self._dq_lock = threading.Lock()

    def push(self, frame: np.ndarray) -> bool:
        """Add one frame; False when the oldest frame was dropped to make room."""
        data = np.ascontiguousarray(frame).reshape(-1).view(np.uint8)
        if data.nbytes != self.frame_bytes:
            raise ValueError(f"a frame of this ring is {self.frame_bytes} bytes, got {data.nbytes}")
        if self._lib is not None:
            return bool(self._lib.ring_push(self._handle, _u8ptr(data)))
        with self._dq_lock:
            dropped = len(self._deque) == self.capacity
            self._deque.append(np.array(data, copy=True))
            return not dropped

    def pop(self, max_frames: int) -> np.ndarray:
        """(n, frame_bytes) uint8 of the up to ``max_frames`` oldest frames, oldest first."""
        if self._lib is not None:
            out = np.empty((max_frames, self.frame_bytes), np.uint8)
            n = self._lib.ring_pop(self._handle, _u8ptr(out), max_frames)
            return out[:n]
        with self._dq_lock:
            frames = [self._deque.popleft() for _ in range(min(len(self._deque), max_frames))]
        return np.stack(frames) if frames else np.empty((0, self.frame_bytes), np.uint8)

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.ring_size(self._handle))
        with self._dq_lock:
            return len(self._deque)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_handle", None):
            self._lib.ring_destroy(self._handle)
