"""The benchmark's inputs: synthetic colibri scenes, frozen here.

A copy of the port's synthetic generator (``data/synthetic.py`` with the
PNG and YAML writers it uses), kept apart so that the benchmark's inputs
never change with the program.  It imports nothing of the program.

* ``render_frame`` draws one scene (a textured cuboid "drill" and a
  21-joint hand) from a ``RandomState`` and renders it through a pinhole
  camera of focal ``480 * scale`` at any frame size; ``scale`` may be
  fractional (the serving frames: 896x504 at 3.5 times the focal of the
  256 px training frames, so the drill covers the share of the network's
  input it covers in training).
* ``generate_dataset`` writes a LINEMOD-layout set (rgb/, mask/, hands/,
  gt_0.yml, info_0.yml, split lists, models/) that the program's reader
  reads, and returns every frame and label in memory for the reference.
* ``serving_frame`` is frame ``i`` of a seed's serving pool, drawn from its
  own ``RandomState``, so a pool frame can be made again alone.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Dict, List

import numpy as np

_ARM_MM_PER_MM_OFFSET = 0.12
HAND_CANONICAL_MM = np.array(
    [
        [0.0, 0.0, 0.0],
        [-28, 18, 8], [-44, 36, 12], [-54, 50, 14], [-62, 62, 16],
        [-22, 70, 0], [-24, 98, 2], [-25, 117, 3], [-26, 130, 4],
        [0, 73, 0], [0, 103, 2], [0, 124, 3], [0, 139, 4],
        [20, 69, 0], [22, 96, 2], [23, 115, 3], [24, 128, 4],
        [38, 62, 0], [42, 82, 1], [44, 96, 2], [46, 107, 3],
    ],
    dtype=np.float64,
)
HAND_BONES = tuple((0 if k == 0 else 4 * f + k, 4 * f + k + 1) for f in range(5) for k in range(4))
_HAND_SCALE = 0.6
_HAND_JITTER_MM = 8.0
DRILL_SIZE_MM = (40.0, 24.0, 110.0)


def axis_angle_to_matrix(v) -> np.ndarray:
    """Rodrigues, float64."""
    v = np.asarray(v, np.float64)
    angle = float(np.linalg.norm(v))
    if angle < 1e-12:
        return np.eye(3)
    x, y, z = v / angle
    k = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return np.eye(3) + math.sin(angle) * k + (1.0 - math.cos(angle)) * (k @ k)


def cuboid_points(size=DRILL_SIZE_MM, n=600, rng=None) -> np.ndarray:
    """Points on the surface of a box centred at the origin (mm)."""
    rng = rng or np.random.RandomState(0)
    pts = rng.uniform(-0.5, 0.5, size=(n, 3)) * np.array(size)
    face = rng.randint(0, 3, size=n)
    sign = rng.choice([-0.5, 0.5], size=n)
    for i in range(n):
        pts[i, face[i]] = sign[i] * size[face[i]]
    return pts


def _project(points, rot_mat, trans, cam_k):
    cam = points @ rot_mat.T + trans
    z = np.clip(cam[:, 2], 1e-6, None)
    u = cam_k[0, 0] * cam[:, 0] / z + cam_k[0, 2]
    v = cam_k[1, 1] * cam[:, 1] / z + cam_k[1, 2]
    return np.stack([u, v], axis=1), z


def _splat(image, mask, uv, z, colors, radius=3, mask_value=255):
    """Painter's-algorithm square splats, far to near."""
    h, w = image.shape[:2]
    radii = np.broadcast_to(np.asarray(radius, int), (len(uv),))
    for i in np.argsort(-z):
        x, y = int(round(uv[i, 0])), int(round(uv[i, 1]))
        r = int(radii[i])
        if 0 <= x < w and 0 <= y < h:
            x0, x1 = max(0, x - r), min(w, x + r + 1)
            y0, y1 = max(0, y - r), min(h, y + r + 1)
            image[y0:y1, x0:x1] = colors[i]
            mask[y0:y1, x0:x1] = mask_value


def hand_joint_colors() -> np.ndarray:
    base = np.array([[235, 235, 235], [235, 45, 45], [45, 235, 45], [70, 70, 235], [235, 235, 45],
                     [235, 45, 235]], dtype=np.float64)
    colors = [base[0]]
    for f in range(5):
        for k in range(4):
            colors.append(base[f + 1] * (0.55 + 0.15 * k))
    return np.clip(np.rint(np.array(colors)), 0, 255).astype(np.uint8)


def drill_model(rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    points = cuboid_points(rng=rng)
    size = points.max(axis=0) - points.min(axis=0)
    norm = (points - points.min(axis=0)) / np.maximum(size, 1e-6)
    return {"points": points, "colors": (40 + 200 * norm).astype(np.uint8),
            "tip": points[np.argmax(points[:, 2])]}


def render_frame(rng: np.random.RandomState, model: Dict[str, np.ndarray], width: int, height: int,
                 scale: float = 1.0) -> Dict[str, np.ndarray]:
    """One scene: the drill at a random pose (z 400-700 mm), a hand beside
    it, rendered at ``width`` x ``height`` with focal ``480 * scale``.
    Returns the frame, its mask and labels (rotation vector, translation mm,
    hand joints m, camera matrix)."""
    s = float(scale)
    cam_k = np.array([[480.0 * s, 0.0, width / 2], [0.0, 480.0 * s, height / 2], [0.0, 0.0, 1.0]])
    rotvec = rng.normal(size=3)
    rotvec = rotvec / np.linalg.norm(rotvec) * rng.uniform(0.0, np.pi * 0.9)
    trans = np.array([rng.uniform(-60, 60), rng.uniform(-60, 60), rng.uniform(400, 700)])
    rot_mat = axis_angle_to_matrix(rotvec)
    image = rng.randint(20, 80, size=(height, width, 3)).astype(np.uint8)
    mask = np.zeros((height, width), np.uint8)
    uv, z = _project(model["points"], rot_mat, trans, cam_k)
    _splat(image, mask, uv, z, model["colors"], radius=int(round(3 * s)))

    ang = rng.uniform(0.0, 2 * np.pi)
    lateral_mm = rng.uniform(18.0, 40.0)
    hand_center = trans + lateral_mm * np.array([np.cos(ang), np.sin(ang), 0.0]) + rng.normal(scale=10.0, size=3)
    hand_rotvec = rng.normal(size=3)
    hand_rotvec = hand_rotvec / np.linalg.norm(hand_rotvec) * rng.uniform(0.0, np.pi)
    hand_rot = axis_angle_to_matrix(hand_rotvec)
    canonical = (HAND_CANONICAL_MM - HAND_CANONICAL_MM.mean(axis=0)) * _HAND_SCALE
    hand_mm = hand_center + canonical @ hand_rot.T + rng.normal(scale=_HAND_JITTER_MM, size=(21, 3))

    colors = hand_joint_colors()
    blank = np.zeros((height, width), np.uint8)
    eye, origin = np.eye(3), np.zeros(3)
    n_bone, n_arm, n_arrow = (max(2, int(round(c * s))) for c in (24, 14, 18))
    bone_pts, bone_cols = [], []
    for parent, child in HAND_BONES:
        ts = np.linspace(0.0, 1.0, n_bone)[:, None]
        bone_pts.append(hand_mm[parent] + ts * (hand_mm[child] - hand_mm[parent]))
        dim = np.clip(np.rint(colors[child].astype(np.float64) * 0.7), 0, 255).astype(np.uint8)
        bone_cols.append(np.repeat(dim[None], n_bone, axis=0))
    uv, z = _project(np.concatenate(bone_pts), eye, origin, cam_k)
    _splat(image, blank, uv, z, np.concatenate(bone_cols), radius=max(1, int(round(s))))
    z_off = hand_mm[:, 2] - trans[2]
    arm_pts, arm_cols = [], []
    for j in range(21):
        axis = np.array([1.0, 0.0, 0.0]) if z_off[j] >= 0 else np.array([0.0, 1.0, 0.0])
        ts = np.linspace(0.0, 1.0, n_arm)[:, None]
        arm_pts.append(hand_mm[j] + ts * axis * abs(z_off[j]) * _ARM_MM_PER_MM_OFFSET)
        arm_cols.append(np.repeat(colors[j:j + 1], n_arm, axis=0))
    uv, z = _project(np.concatenate(arm_pts), eye, origin, cam_k)
    _splat(image, blank, uv, z, np.concatenate(arm_cols), radius=max(0, int(round(s)) - 1))
    for axis_vec, col in ((np.array([0.0, 1.0, 0.0]), np.array([0, 255, 255], np.uint8)),
                          (np.array([1.0, 0.0, 0.0]), np.array([255, 128, 0], np.uint8))):
        ts = np.linspace(0.0, 1.0, n_arrow)[:, None]
        uv, z = _project(hand_mm[0] + ts * (hand_rot @ (axis_vec * 50.0)), eye, origin, cam_k)
        _splat(image, blank, uv, z, np.repeat(col[None], n_arrow, axis=0), radius=max(1, int(round(s))))
    uv, z = _project(hand_mm, eye, origin, cam_k)
    radius = np.clip(np.rint(1400.0 * s / z), s, 4 * s).astype(int)
    _splat(image, blank, uv, z, colors, radius=radius)
    return {"image": image, "mask": mask, "rotvec": rotvec, "rot_mat": rot_mat, "trans": trans,
            "hand": hand_mm / 1000.0, "cam_k": cam_k}


def serving_frame(seed: int, index: int, height: int, width: int, scale: float) -> np.ndarray:
    """Frame ``index`` of the serving pool of ``seed``: (H, W, 3) uint8 RGB."""
    model = drill_model(np.random.RandomState([seed % (2 ** 32), 0x5E12]))
    rng = np.random.RandomState([seed % (2 ** 32), 0x5E12, index + 1])
    return render_frame(rng, model, width, height, scale)["image"]


# -- writers --------------------------------------------------------------------

def write_png(path: str, image: np.ndarray) -> None:
    """uint8 (H, W) or (H, W, 3) -> 8-bit PNG, filter type 0."""
    image = np.ascontiguousarray(image)
    height, width = image.shape[:2]
    colour = 0 if image.ndim == 2 else 2
    rows = image.reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    header = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw, 1))
                + chunk(b"IEND", b""))


def _yaml_scalar(value) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    text = repr(float(value)).lower()
    return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text


def _yaml_lines(node, indent: int, out: List[str]) -> None:
    """Block YAML as ``yaml.safe_dump`` lays it out (sorted keys, a sequence
    under a key at the key's indent), for dicts, lists and numbers."""
    pad = " " * indent
    if isinstance(node, dict):
        for key in sorted(node):
            value = node[key]
            if isinstance(value, dict):
                out.append(f"{pad}{key}:")
                _yaml_lines(value, indent + 2, out)
            elif isinstance(value, list):
                out.append(f"{pad}{key}:")
                _yaml_lines(value, indent, out)
            else:
                out.append(f"{pad}{key}: {_yaml_scalar(value)}")
    else:
        for item in node:
            if isinstance(item, dict):
                inner: List[str] = []
                _yaml_lines(item, indent + 2, inner)
                out.append(f"{pad}- {inner[0].lstrip()}")
                out.extend(inner[1:])
            else:
                out.append(f"{pad}- {_yaml_scalar(item)}")


def write_yaml(path: str, data) -> None:
    out: List[str] = []
    _yaml_lines(data, 0, out)
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def bbox_from_mask(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return np.zeros(4, np.float32)
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float32)


def generate_dataset(root: str, num_frames: int, size: int, seed: int, val_frames: int = 2
                     ) -> Dict[str, np.ndarray]:
    """Write a one-object colibri set of ``num_frames`` frames of ``size`` px
    (focal ``480 * size / 256``) under ``root``; all but ``val_frames`` are
    the train split.  Returns the train split in the reader's order (sorted
    frame ids), as arrays: frames, masks, boxes, rotations, translations,
    hands, cameras, and the drill's points."""
    rng = np.random.RandomState(seed % (2 ** 32))
    scale = size / 256.0
    obj = os.path.join(root, "data", "01")
    for sub in ("rgb", "mask", "hands"):
        os.makedirs(os.path.join(obj, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "models"), exist_ok=True)
    model = drill_model(rng)
    pts = model["points"]
    extent = pts.max(axis=0) - pts.min(axis=0)
    with open(os.path.join(root, "models", "obj_01.ply"), "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\nend_header\n")
        f.writelines(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n" for p in pts)
    mins = pts.min(axis=0)
    write_yaml(os.path.join(root, "models", "models_info.yml"), {1: {
        "diameter": float(np.linalg.norm(extent)), "min_x": float(mins[0]), "min_y": float(mins[1]),
        "min_z": float(mins[2]), "size_x": float(extent[0]), "size_y": float(extent[1]),
        "size_z": float(extent[2])}})
    gt, info, frames = {}, {}, []
    tip = [float(v) for v in model["tip"]] + [1.0]
    for i in range(num_frames):
        f = render_frame(rng, model, size, size, scale)
        write_png(os.path.join(obj, "rgb", f"{i:06d}.png"), f["image"])
        write_png(os.path.join(obj, "mask", f"{i:06d}.png"), f["mask"])
        np.save(os.path.join(obj, "hands", f"{i:06d}_coords_3d.npy"), f["hand"])
        gt[i] = [{"cam_R_m2c": [float(x) for x in f["rot_mat"].reshape(-1)],
                  "cam_t_m2c": [float(x) for x in f["trans"]], "obj_bb": [0, 0, 1, 1], "obj_id": 1,
                  "drill_tip_transform": list(tip)}]
        info[i] = {"cam_K": [float(x) for x in f["cam_k"].reshape(-1)], "depth_scale": 1.0}
        frames.append(f)
    ids = list(range(num_frames))
    rng.shuffle(ids)
    splits = {"test": ids[:1], "val": ids[1:1 + val_frames], "train": sorted(ids[1 + val_frames:])}
    write_yaml(os.path.join(obj, "gt_0.yml"), gt)
    write_yaml(os.path.join(obj, "info_0.yml"), info)
    for name, frame_ids in splits.items():
        with open(os.path.join(obj, f"{name}_0.txt"), "w") as fh:
            fh.write("\n".join(f"{i:06d}" for i in sorted(frame_ids)) + "\n")
    train = [frames[i] for i in splits["train"]]
    return {
        "frames": np.stack([f["image"] for f in train]),
        "masks": np.stack([f["mask"] for f in train]),
        "boxes": np.stack([bbox_from_mask(f["mask"]) for f in train]),
        "rotvecs": np.stack([f["rotvec"] for f in train]),
        "rot_mats": np.stack([f["rot_mat"] for f in train]),
        "translations": np.stack([f["trans"] for f in train]),
        "hands": np.stack([f["hand"] for f in train]),
        "cameras": np.stack([f["cam_k"] for f in train]),
        "points": pts,
    }
