"""The training split resident on the device; batches gathered by index there.

Counterpart of ``hmd_ego_pose_tpu/data/device_dataset.py``.  The colibri
training splits are a few hundred frames: the v3 set's 600 train frames at
256x256 are 157 MB of frames and masks, far under the card's memory.  They
are uploaded once, and each step the host sends a (B,) index vector.

``build_host_cache`` decodes the split into host arrays, ``upload_window``
uploads them (all, or the rows of one window), ``gather_raw_batch`` gathers
a batch on the device.  A split larger than the trainer's budget goes up one
window at a time into a ``WindowBuffer``: one window's rows, allocated once
and filled in place for each window, so that the window is the only one on
the device and a captured CUDA graph of the step reads every window at the
same addresses (``train/step.py::ResidentGraph``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hmd_ego_pose_tpu_torch.ops.augment_device import RawBatch
from hmd_ego_pose_tpu_torch.utils.device import PackedFields


class HostCache(NamedTuple):
    """The decoded split in host RAM; leading dimension = frames."""

    frames: np.ndarray  # (N, H, W, 3) uint8
    masks: np.ndarray  # (N, H, W) uint8
    camera_fxfycxcy: np.ndarray  # (N, 4) float32
    gt_boxes: np.ndarray  # (N, K, 4)
    gt_rotations: np.ndarray  # (N, K, 3)
    gt_is_sym: np.ndarray  # (N, K)
    gt_translations: np.ndarray  # (N, K, 3)
    gt_coords_3d: np.ndarray  # (N, K, 21, 3)
    gt_labels: np.ndarray  # (N, K) int32
    gt_valid: np.ndarray  # (N, K) bool
    gt_mask_values: np.ndarray  # (N, K) int32

    def bytes_per_frame(self) -> int:
        n = self.frames.shape[0]
        return sum(a.nbytes for a in self) // max(1, n)


class DeviceData(NamedTuple):
    """The same arrays as tensors on the device (``HostCache`` field order)."""

    frames: torch.Tensor
    masks: torch.Tensor
    camera_fxfycxcy: torch.Tensor
    gt_boxes: torch.Tensor
    gt_rotations: torch.Tensor
    gt_is_sym: torch.Tensor
    gt_translations: torch.Tensor
    gt_coords_3d: torch.Tensor
    gt_labels: torch.Tensor
    gt_valid: torch.Tensor
    gt_mask_values: torch.Tensor


def build_host_cache(dataset, max_objects: int = 1) -> HostCache:
    """Decode every frame, mask and label of ``dataset`` into host arrays."""
    n, k = len(dataset), max_objects
    probe = dataset.load_image(0)
    h, w = probe.shape[:2]
    frames = np.zeros((n, h, w, 3), np.uint8)
    masks = np.zeros((n, h, w), np.uint8)
    cam4 = np.zeros((n, 4), np.float32)
    boxes = np.zeros((n, k, 4), np.float32)
    rots = np.zeros((n, k, 3), np.float32)
    is_sym = np.zeros((n, k), np.float32)
    trans = np.zeros((n, k, 3), np.float32)
    coords = np.zeros((n, k, 21, 3), np.float32)
    labels = np.zeros((n, k), np.int32)
    valid = np.zeros((n, k), bool)
    mask_values = np.full((n, k), 255, np.int32)
    for i in range(n):
        frames[i] = dataset.load_image(i)
        m = dataset.load_mask(i)
        masks[i] = m[..., 0] if m.ndim == 3 else m
        cam = dataset.load_camera_matrix(i)
        cam4[i] = [cam[0, 0], cam[1, 1], cam[0, 2], cam[1, 2]]
        anno = dataset.load_annotations(i)
        num = min(anno["labels"].shape[0], k)
        boxes[i, :num] = anno["bboxes"][:num]
        rots[i, :num] = anno["rotations"][:num, :3]
        is_sym[i, :num] = anno["rotations"][:num, 3]
        trans[i, :num] = anno["translations"][:num]
        coords[i, :num] = anno["coords_3d"][:num]
        labels[i, :num] = anno["labels"][:num]
        valid[i, :num] = True
        if "mask_values" in anno:
            mask_values[i, :num] = anno["mask_values"][:num]
        elif num > 1:
            raise ValueError("multi-object frames need per-object 'mask_values' in annotations")
    return HostCache(frames, masks, cam4, boxes, rots, is_sym, trans, coords, labels, valid, mask_values)


def upload_window(cache: HostCache, rows: Optional[np.ndarray], device: torch.device) -> DeviceData:
    """Upload the cache's ``rows`` (None: every frame) to ``device``, one copy per field."""
    def sel(a):
        return np.ascontiguousarray(a if rows is None else a[rows])

    return DeviceData(*(torch.from_numpy(sel(a)).to(device) for a in cache))


class WindowBuffer:
    """``frames`` rows of every field of a ``HostCache`` on ``device``, packed
    in one buffer (``utils/device.py::PackedFields``: pinned host staging of
    the same layout, one host-to-device copy a window).  ``data`` holds the
    fields as a ``DeviceData`` of views at fixed addresses."""

    def __init__(self, cache: HostCache, frames: int, device: torch.device):
        self.frames = frames
        self.packed = PackedFields({name: ((frames,) + a.shape[1:], torch.from_numpy(a[:0]).dtype)
                                    for name, a in zip(HostCache._fields, cache)}, device)
        self.data = DeviceData(*(self.packed[name] for name in HostCache._fields))

    def fill(self, cache: HostCache, rows: np.ndarray) -> DeviceData:
        """Copy the cache's ``rows`` (at most ``frames``) into the first rows of
        the buffer; the rows after them keep what they held.  Returns ``data``."""
        if len(rows) > self.frames:
            raise ValueError(f"{len(rows)} rows for a window of {self.frames} frames")
        self.packed.wait()  # the last window's copy has left the host buffer
        for name, a in zip(HostCache._fields, cache):
            np.take(a, rows, axis=0, out=self.packed.host[name].numpy()[:len(rows)])
        self.packed.upload()
        return self.data


def gather_raw_batch(data: DeviceData, idx: torch.Tensor) -> RawBatch:
    """(B,) frame indices on the device -> the batch's ``RawBatch`` (one
    ``index_select`` per field; indices come from the host sampler, in range)."""
    take = [torch.index_select(a, 0, idx) for a in data]
    return RawBatch(*take)
