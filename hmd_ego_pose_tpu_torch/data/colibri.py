"""Colibri (syn/real) dataset reader, LINEMOD on-disk layout.

Counterpart of ``hmd_ego_pose_tpu/data/colibri.py`` with the reader protocol
the evaluator and the trainer use (``preload``, ``load_mask`` and
``model_points_for_loss`` for training).  It reads the same files into the same annotations:

* per-fold split files ``{train,val,test}_{fold}.txt``;
* ``gt_{fold}.yml``: per-frame ``cam_R_m2c`` (row-major 9-vector),
  ``cam_t_m2c`` (mm), ``obj_id``, ``drill_tip_transform``;
* ``info_{fold}.yml``: per-frame ``cam_K`` intrinsics;
* ``models/obj_{id:02d}.ply`` and ``models_info.yml`` (diameter);
* hand joints from ``hands/{frame}_coords_3d.npy`` (meters);
* the 2-D bbox from the segmentation mask;
* object id 2 and the name "none" are symmetric.

YAML goes through the port's own subset reader (``data/yml.py``) and PNG
through its own decoder (``data/image.py``).  ``object_ids`` reads a
multi-object scene: the frames live under the first id's scene dir, the
shared mask holds each object at its own pixel value (``mask_values.yml``),
and annotations get one row per object present.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from hmd_ego_pose_tpu_torch.data import yml
from hmd_ego_pose_tpu_torch.data.image import read_png
from hmd_ego_pose_tpu_torch.data.ply import load_ply_vertices
from hmd_ego_pose_tpu_torch.ops.geometry import matrix_to_axis_angle


def get_bbox_from_mask(mask: np.ndarray, mask_value: Optional[int] = None):
    """(x1, y1, x2, y2) float32 bbox of the mask's nonzero (or ``mask_value``) pixels, and whether any."""
    if mask.ndim == 3:
        mask = mask[..., 0]
    sel = (mask != 0) if mask_value is None else (mask == mask_value)
    ys, xs = np.where(sel)
    if ys.size == 0:
        return np.zeros((4,), np.float32), False
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float32), True


def project_origin_2d(rotation_vector, translation_vector, camera_matrix):
    """Pixel of the object-frame origin (R @ 0 + t = t) through the camera."""
    t = np.asarray(translation_vector, np.float64)
    u = camera_matrix[0, 0] * t[0] / t[2] + camera_matrix[0, 2]
    v = camera_matrix[1, 1] * t[1] / t[2] + camera_matrix[1, 2]
    return np.array([u, v], np.float64)


def subsample_model_points(points: np.ndarray, count: int) -> np.ndarray:
    """Deterministic stride subsample, or zero pad, to ``count`` float32 points:
    stride ``(num // count) - 1`` clamped at 1, then truncate."""
    num = points.shape[0]
    if num == count:
        return points.astype(np.float32)
    if num < count:
        out = np.zeros((count, 3), np.float32)
        out[:num] = points
        return out
    step = max((num // count) - 1, 1)
    return points[::step][:count].astype(np.float32)


class ColibriDataset:
    """Random-access reader for one object (or scene) of a colibri fold + partition."""

    def __init__(
        self,
        dataset_path: str,
        fold: int = 0,
        object_id: int = 1,
        partition: str = "train",
        image_extension: str = ".png",
        symmetric_objects=frozenset({"none", 2}),
        rotation_parameter: int = 3,
        object_ids=None,
    ):
        self.dataset_path = dataset_path
        self.object_id = object_id if object_ids is None else object_ids[0]
        self.object_ids = list(object_ids) if object_ids is not None else [object_id]
        object_id = self.object_id
        self.partition = partition
        self.symmetric_objects = symmetric_objects
        self.rotation_parameter = rotation_parameter

        model_dir = os.path.join(dataset_path, "models")
        object_path = os.path.join(dataset_path, "data", f"{object_id:02d}")
        if not os.path.isdir(object_path):
            object_path = os.path.join(dataset_path, "data", str(object_id))  # unpadded ids
        self.object_path = object_path

        with open(os.path.join(object_path, f"{partition}_{fold}.txt")) as f:
            examples = {line.strip() for line in f if line.strip()}
        gt_dict = yml.load(os.path.join(object_path, f"gt_{fold}.yml"))
        info_dict = yml.load(os.path.join(object_path, f"info_{fold}.yml"))
        models_info = yml.load(os.path.join(model_dir, "models_info.yml"))

        self.models_info = [models_info[oid] for oid in self.object_ids]
        self.diameters = [float(mi["diameter"]) for mi in self.models_info]
        self.models_3d_points = [
            load_ply_vertices(os.path.join(model_dir, f"obj_{oid:02d}.ply")) for oid in self.object_ids
        ]

        multi = len(self.object_ids) > 1
        if not multi:
            self._mask_values = {self.object_ids[0]: 255}
        else:
            mv_path = os.path.join(object_path, "mask_values.yml")
            if not os.path.isfile(mv_path):
                raise FileNotFoundError(f"multi-object scene needs {mv_path} (obj_id -> mask pixel value)")
            self._mask_values = {int(k): int(v) for k, v in yml.load(mv_path).items()}

        rgb_dir = os.path.join(object_path, "rgb")
        names = sorted(
            fn for fn in os.listdir(rgb_dir)
            if fn.endswith(image_extension) and fn[: -len(image_extension)] in examples
        )
        self.image_paths = [os.path.join(rgb_dir, fn) for fn in names]
        self.mask_paths = [p.replace("rgb", "mask") for p in self.image_paths]
        self.frame_ids = [int(fn.split(".")[0]) for fn in names]

        self.infos, self.annotations = [], []
        for frame_id, mask_path in zip(self.frame_ids, self.mask_paths):
            cam_k = np.reshape(np.asarray(info_dict[frame_id]["cam_K"], np.float64), (3, 3))
            self.infos.append(cam_k)
            mask = read_png(mask_path)
            # one hand per frame, replicated to every row
            hands_dir = os.path.join(os.path.dirname(os.path.dirname(mask_path)), "hands")
            hand = np.load(os.path.join(hands_dir, f"{frame_id:06d}_coords_3d.npy"))

            rows = []
            for cls, oid in enumerate(self.object_ids):
                gt = next(g for g in gt_dict[frame_id] if g["obj_id"] == oid)
                rot_mat = np.reshape(np.asarray(gt["cam_R_m2c"], np.float64), (3, 3))
                rotvec = matrix_to_axis_angle(rot_mat)
                trans = np.asarray(gt["cam_t_m2c"], np.float64)
                bbox, ok = get_bbox_from_mask(mask, self._mask_values[oid] if multi else None)
                if multi and not ok:
                    continue  # fully occluded or out of frame: no row
                tip = np.asarray(gt["drill_tip_transform"], np.float64)
                rows.append((cls, oid, rotvec, trans, bbox, tip))

            k = len(rows)
            anno = {
                "labels": np.zeros((k,), np.int64),
                "bboxes": np.zeros((k, 4), np.float64),
                "rotations": np.zeros((k, self.rotation_parameter + 2), np.float64),
                "translations": np.zeros((k, 3), np.float64),
                "translations_x_y_2D": np.zeros((k, 2), np.float64),
                "coords_3d": np.zeros((k, 21, 3), np.float64),
                "drill_tip_transform": np.zeros((k, 4), np.float64),
            }
            if multi:
                anno["mask_values"] = np.zeros((k,), np.int64)
            for r, (cls, oid, rotvec, trans, bbox, tip) in enumerate(rows):
                anno["labels"][r] = cls
                anno["bboxes"][r] = bbox
                anno["rotations"][r, :3] = rotvec
                anno["rotations"][r, 3] = float(self.is_symmetric_object(oid))
                anno["rotations"][r, 4] = float(cls)
                anno["translations"][r] = trans
                anno["translations_x_y_2D"][r] = project_origin_2d(rotvec, trans, cam_k)
                anno["coords_3d"][r] = hand
                anno["drill_tip_transform"][r] = tip
                if multi:
                    anno["mask_values"][r] = self._mask_values[oid]
            self.annotations.append(anno)

        if multi:
            self.class_to_name = {c: f"object_{oid:02d}" for c, oid in enumerate(self.object_ids)}
            self.class_labels_to_object_ids = dict(enumerate(self.object_ids))
        else:
            self.class_to_name = {0: "object"}
            self.class_labels_to_object_ids = {0: object_id}

    def __len__(self):
        return len(self.image_paths)

    def is_symmetric_object(self, name_or_id) -> bool:
        return name_or_id in self.symmetric_objects

    def preload(self, budget_bytes: int = 8 << 30) -> bool:
        """Decode every frame and mask once into a read-only cache in host RAM;
        False (and nothing cached) when the decoded set would exceed ``budget_bytes``."""
        if getattr(self, "_image_cache", None) is not None:
            return True
        if not self.image_paths:
            return False
        probe, mask_probe = read_png(self.image_paths[0]), read_png(self.mask_paths[0])
        if len(self.image_paths) * (probe.nbytes + mask_probe.nbytes) > budget_bytes:
            return False
        images, masks = [], []
        for ip, mp in zip(self.image_paths, self.mask_paths):
            im, mk = read_png(ip), read_png(mp)
            im.setflags(write=False)
            mk.setflags(write=False)
            images.append(im)
            masks.append(mk)
        self._image_cache, self._mask_cache = images, masks
        return True

    def load_image(self, i: int) -> np.ndarray:
        cache = getattr(self, "_image_cache", None)
        return cache[i] if cache is not None else read_png(self.image_paths[i])

    def load_mask(self, i: int) -> np.ndarray:
        """(H, W, 3) uint8 mask (a gray PNG read as RGB)."""
        cache = getattr(self, "_mask_cache", None)
        return cache[i] if cache is not None else read_png(self.mask_paths[i])

    def load_annotations(self, i: int) -> Dict[str, np.ndarray]:
        return {k: v.copy() for k, v in self.annotations[i].items()}

    def load_camera_matrix(self, i: int) -> np.ndarray:
        return self.infos[i].copy()

    def load_drill_tip_offset(self, i: int) -> np.ndarray:
        return self.annotations[i]["drill_tip_transform"].copy()

    def model_points_for_loss(self, count: int = 500) -> np.ndarray:
        """(num_classes, count, 3) float32 subsample of each model's points for the loss."""
        return np.stack([subsample_model_points(pts, count) for pts in self.models_3d_points])

    def get_models_3d_points_dict(self):
        return dict(enumerate(self.models_3d_points))

    def get_objects_diameter_dict(self):
        return dict(enumerate(self.diameters))
