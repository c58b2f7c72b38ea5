"""Wire protocol of the pose-streaming service.

A copy of ``hmd_ego_pose_tpu/serving/protocol.py``: the same messages, byte
for byte.

Frame message (little-endian): magic u32 0x48454750 ("HEGP"), kind u8
(0 = RGB8, 1 = I420, 2 = NV12), height u16, width u16, then the payload:
h*w*3 bytes (RGB8) or h*w*3/2 bytes (I420, NV12; ``serving/frameio.py``
decodes them, and both sizes must be even).  Response: one 24-byte pose
packet per frame, six float32 [rvec (radians), tvec (meters)], or 24 bytes
of NaN when no detection cleared the score threshold.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from hmd_ego_pose_tpu_torch.serving import frameio

MAGIC = 0x48454750
HEADER_FMT = "<IBHH"
HEADER_BYTES = struct.calcsize(HEADER_FMT)
POSE_PACKET_BYTES = 24
KIND_RGB8 = 0
KIND_I420 = 1
KIND_NV12 = 2


def encode_frame_message(frame: np.ndarray, kind: int = KIND_RGB8) -> bytes:
    """A frame array -> one frame message of ``kind``, its height and width
    read from ``frame.shape[:2]`` (an (H, W, 3) uint8 RGB frame for RGB8)."""
    h, w = frame.shape[:2]
    return struct.pack(HEADER_FMT, MAGIC, kind, h, w) + np.ascontiguousarray(frame).tobytes()


def encode_raw_frame_message(payload: bytes, kind: int, height: int, width: int) -> bytes:
    """Frame message from an already-encoded payload (I420/NV12 planes)."""
    if len(payload) != payload_size(kind, height, width):
        raise ValueError(
            f"payload is {len(payload)} bytes, kind {kind} at {height}x{width} "
            f"needs {payload_size(kind, height, width)}"
        )
    return struct.pack(HEADER_FMT, MAGIC, kind, height, width) + payload


def payload_size(kind: int, height: int, width: int) -> int:
    """Payload bytes of a frame; raises for an unknown kind, and for odd sizes of I420 and NV12."""
    if kind == KIND_RGB8:
        return height * width * 3
    if kind in (KIND_I420, KIND_NV12):
        return frameio.yuv420_size(height, width)
    raise ValueError(f"unknown frame kind {kind}")


def decode_frame_header(header: bytes) -> Tuple[int, int, int]:
    magic, kind, h, w = struct.unpack(HEADER_FMT, header)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    return kind, h, w


def decode_frame_message(data: bytes) -> np.ndarray:
    kind, h, w = decode_frame_header(data[:HEADER_BYTES])
    payload = np.frombuffer(data[HEADER_BYTES:], np.uint8)
    if payload.size != payload_size(kind, h, w):
        raise ValueError(f"payload is {payload.size} bytes, expected {payload_size(kind, h, w)}")
    if kind == KIND_I420:
        return frameio.i420_to_rgb(payload, h, w)
    if kind == KIND_NV12:
        return frameio.nv12_to_rgb(payload, h, w)
    return payload.reshape(h, w, 3)


def encode_pose_packet(rotation_rad: np.ndarray, translation_m: np.ndarray) -> bytes:
    """Six little-endian float32: axis-angle radians + translation meters."""
    vals = np.concatenate([np.asarray(rotation_rad), np.asarray(translation_m)]).astype("<f4")
    if vals.shape != (6,):
        raise ValueError(f"a pose packet holds 6 floats, got {vals.shape}")
    return vals.tobytes()


def decode_pose_packet(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    vals = np.frombuffer(data, "<f4")
    return vals[:3].copy(), vals[3:].copy()


def no_detection_packet() -> bytes:
    return np.full((6,), np.nan, "<f4").tobytes()
