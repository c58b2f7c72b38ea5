"""Offline dataset preparation: per-frame pickle dumps to the LINEMOD layout.

Counterpart of ``hmd_ego_pose_tpu/data/format_labels.py``: takes the
per-frame pickle records of the synthetic and real colibri releases and
writes the dataset ``data/colibri.py::ColibriDataset`` reads.

Per-frame pickle schema:
    rgb: (H, W, 3) uint8; mask: (H, W[, 3]) with the object in the red
    channel; affine_transform: (3, 4) or (4, 4) model-to-camera pose in
    meters; cam_calib (or camera_matrix): (3, 3) intrinsics; coords_3d:
    (21, 3) hand joints; drill_tip_transform: (3,) or (4,) tip offset.

The same conversions as the JAX package's:

* masks binarized from the red channel (above 10 -> 255);
* the model's re-centring offset (0.048, 0.1129, -0.0845) m applied to the
  pose, and translations from meters to millimetres;
* a tip given in meters (3 values, or 4 with a homogeneous 1 and every
  coordinate under 10) to millimetres;
* frames whose mask is empty are skipped;
* ``gt_{fold}.yml`` and ``info_{fold}.yml`` (``data/yml.py``, byte-equal to
  ``yaml.safe_dump``), the frames as PNGs (``data/image.py::write_png``), the
  hands as ``.npy``, and ``{train,val,test}_{fold}.txt`` splitting the kept
  frames 60/20/20 in order unless ``splits`` is given.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from hmd_ego_pose_tpu_torch.data import yml
from hmd_ego_pose_tpu_torch.data.image import write_png

# the model's re-centring offset in meters
MODEL_RECENTER_OFFSET_M = np.array([0.048, 0.1129, -0.0845])
M_TO_MM = 1000.0


def binarize_mask(mask: np.ndarray, threshold: int = 10) -> np.ndarray:
    """Object mask from the red channel -> {0, 255} uint8."""
    red = mask[..., 0] if mask.ndim == 3 else mask
    return np.where(red > threshold, 255, 0).astype(np.uint8)


def bbox_from_mask(mask: np.ndarray) -> Optional[np.ndarray]:
    """[x, y, w, h] int64 of the nonzero pixels, None when there are none."""
    ys, xs = np.where(mask > 0)
    if ys.size == 0:
        return None
    return np.array([xs.min(), ys.min(), xs.max() - xs.min(), ys.max() - ys.min()], np.int64)


def pose_from_affine(affine: np.ndarray, recenter_offset_m=MODEL_RECENTER_OFFSET_M):
    """(R, t in mm) from an affine in meters, the model's origin moved by the offset."""
    affine = np.asarray(affine, np.float64)
    r = affine[:3, :3]
    t_m = affine[:3, 3]
    # moving the model's origin by o moves the translation by R @ o
    t_m = t_m + r @ recenter_offset_m
    return r, t_m * M_TO_MM


def tip_in_mm(tip) -> np.ndarray:
    """The drill tip as 4 values in mm: a 3-vector or a homogeneous tip with
    every coordinate under 10 is in meters; anything else is kept."""
    tip = np.asarray(tip, np.float64).reshape(-1)
    if tip.shape[0] == 3:
        return np.concatenate([tip * M_TO_MM, [1.0]])
    if abs(tip[3] - 1.0) < 1e-9 and np.abs(tip[:3]).max() < 10:
        return np.concatenate([tip[:3] * M_TO_MM, [1.0]])
    return tip


def convert_pickles(
    pickle_paths: Sequence[str],
    out_root: str,
    object_id: int = 1,
    fold: int = 0,
    splits: Optional[Dict[str, List[int]]] = None,
    skip_frames: Sequence[int] = (),
) -> str:
    """Convert per-frame pickle files (frame id = position in the list) into
    the LINEMOD layout under ``out_root``; returns ``out_root``."""
    obj_dir = os.path.join(out_root, "data", f"{object_id:02d}")
    for sub in ("rgb", "mask", "hands"):
        os.makedirs(os.path.join(obj_dir, sub), exist_ok=True)

    gt: Dict[int, list] = {}
    info: Dict[int, dict] = {}
    frame_ids = []
    for frame_id, path in enumerate(pickle_paths):
        if frame_id in skip_frames:
            continue
        with open(path, "rb") as f:
            record = pickle.load(f)

        rgb = np.asarray(record["rgb"], np.uint8)
        mask = binarize_mask(np.asarray(record["mask"]))
        bb = bbox_from_mask(mask)
        if bb is None:  # a corrupt or empty frame
            continue
        rotation, translation_mm = pose_from_affine(record["affine_transform"])
        cam_k = np.asarray(record.get("cam_calib", record.get("camera_matrix")), np.float64)
        tip = tip_in_mm(record["drill_tip_transform"])

        write_png(os.path.join(obj_dir, "rgb", f"{frame_id:06d}.png"), rgb)
        write_png(os.path.join(obj_dir, "mask", f"{frame_id:06d}.png"), mask)
        coords = np.asarray(record["coords_3d"], np.float64)
        np.save(os.path.join(obj_dir, "hands", f"{frame_id:06d}_coords_3d.npy"), coords)

        gt[frame_id] = [{
            "cam_R_m2c": [float(x) for x in rotation.reshape(-1)],
            "cam_t_m2c": [float(x) for x in translation_mm],
            "obj_bb": [int(x) for x in bb],
            "obj_id": object_id,
            "drill_tip_transform": [float(x) for x in tip],
        }]
        info[frame_id] = {"cam_K": [float(x) for x in cam_k.reshape(-1)], "depth_scale": 1.0}
        frame_ids.append(frame_id)

    yml.dump(gt, os.path.join(obj_dir, f"gt_{fold}.yml"))
    yml.dump(info, os.path.join(obj_dir, f"info_{fold}.yml"))

    if splits is None:
        n = len(frame_ids)
        splits = {
            "train": frame_ids[: int(n * 0.6)],
            "val": frame_ids[int(n * 0.6): int(n * 0.8)],
            "test": frame_ids[int(n * 0.8):],
        }
    for name, ids in splits.items():
        with open(os.path.join(obj_dir, f"{name}_{fold}.txt"), "w") as f:
            f.write("\n".join(f"{i:06d}" for i in ids) + "\n")
    return out_root
