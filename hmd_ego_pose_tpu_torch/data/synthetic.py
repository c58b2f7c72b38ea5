"""Synthetic colibri-layout dataset generator.

Counterpart of ``hmd_ego_pose_tpu/data/synthetic.py``.  It writes a
LINEMOD-format dataset (rgb/, mask/, hands/, gt_{fold}.yml, info_{fold}.yml,
split txts, models/*.ply + models_info.yml) holding a procedurally rendered
rigid "drill" proxy (a coloured cuboid point cloud projected through a
pinhole camera) and a synthetic 21-joint hand.

It draws from the same ``np.random.RandomState(seed)`` sequence with the same
numpy arithmetic as the JAX package's generator, so one seed gives the same
dataset from either package: the same pixels, hands and splits, and YAML
files that are byte-equal (``data/yml.py`` writes what ``yaml.safe_dump``
writes).  PNGs are written by ``data/image.py::write_png`` (pixel-equal, not
byte-equal, to PIL's files).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from hmd_ego_pose_tpu_torch.data import yml
from hmd_ego_pose_tpu_torch.data.image import write_png
from hmd_ego_pose_tpu_torch.ops.geometry import np_axis_angle_to_matrix


def _cuboid_points(size=(40.0, 24.0, 110.0), n=600, rng=None) -> np.ndarray:
    """Dense points on the surface of a box centred at the origin (mm)."""
    rng = rng or np.random.RandomState(0)
    sx, sy, sz = size
    pts = rng.uniform(-0.5, 0.5, size=(n, 3)) * np.array(size)
    # project each point onto a random face to get a surface distribution
    face = rng.randint(0, 3, size=n)
    sign = rng.choice([-0.5, 0.5], size=n)
    for i in range(n):
        pts[i, face[i]] = sign[i] * (sx, sy, sz)[face[i]]
    return pts


def _project(points, rot_mat, trans, cam_k):
    cam = points @ rot_mat.T + trans
    z = np.clip(cam[:, 2], 1e-6, None)
    u = cam_k[0, 0] * cam[:, 0] / z + cam_k[0, 2]
    v = cam_k[1, 1] * cam[:, 1] / z + cam_k[1, 2]
    return np.stack([u, v], axis=1), z


def _splat(image, mask, uv, z, colors, radius=3, mask_value=255):
    """Painter's-algorithm point splat with z-ordering.

    ``colors``: (N, 3) per-point colors.  They are computed from model-frame
    coordinates so the rendered appearance encodes orientation — otherwise
    the 6-DoF rotation would be unlearnable from these images.
    ``radius``: scalar, or a (N,) per-point array (the v3 hand renderer
    scales joint radii by 1/z as a monocular size-depth cue).
    ``mask_value``: pixel value written into ``mask`` (multi-object frames
    give each object its own value so per-object bboxes stay recoverable).
    """
    h, w = image.shape[:2]
    radii = np.broadcast_to(np.asarray(radius, int), (len(uv),))
    order = np.argsort(-z)  # far to near
    for i in order:
        x, y = int(round(uv[i, 0])), int(round(uv[i, 1]))
        r = int(radii[i])
        if 0 <= x < w and 0 <= y < h:
            x0, x1 = max(0, x - r), min(w, x + r + 1)
            y0, y1 = max(0, y - r), min(h, y + r + 1)
            image[y0:y1, x0:x1] = colors[i]
            mask[y0:y1, x0:x1] = mask_value


# Metric arm length per mm of hand-joint z offset from the drill plane (see
# the depth-grounding comment in generate_synthetic_colibri).  At f=480 and
# z~550 mm, a 100 mm offset renders as a ~10 px arm.
_ARM_MM_PER_MM_OFFSET = 0.12

# --- kinematic hand model (MediaPipe 21-joint convention) -------------------
#
# Round-3 finding (TRAIN_SYNTHETIC.md run C): joints rendered as isolated dots
# whose identity was encoded ONLY in subtle per-joint colors (adjacent joints
# differed by 3-9 uint8 steps) are unlearnable under the training-time
# RandAugment color stack — posterize/solarize/contrast destroy a fine-grained
# color code, and the hand loss stayed flat at the predict-the-center level
# while the same data overfit fine WITHOUT augmentation.  Real hands expose
# joint identity STRUCTURALLY (a wrist-rooted kinematic chain), which no color
# op can erase.  The generator therefore renders an articulated skeleton:
# fixed-topology bones + per-FINGER hues separated by >150 uint8 steps (with a
# coarse within-finger brightness ramp), so identity survives any monotone or
# even permuting color distortion via connectivity, and depth stays grounded
# through the projective bone scale plus the explicit z-offset arms.
#
# Canonical pose in mm, wrist at the origin, fingers along +y, palm in the
# xy-plane; joint order: wrist, thumb(4), index(4), middle(4), ring(4),
# pinky(4) — matching the 21x3 hands/*_coords_3d.npy layout the reference
# consumes (pytorch-sandbox/generators/colibri.py hand annotations).
HAND_CANONICAL_MM = np.array(
    [
        [0.0, 0.0, 0.0],                                              # wrist
        [-28, 18, 8], [-44, 36, 12], [-54, 50, 14], [-62, 62, 16],    # thumb
        [-22, 70, 0], [-24, 98, 2], [-25, 117, 3], [-26, 130, 4],     # index
        [0, 73, 0], [0, 103, 2], [0, 124, 3], [0, 139, 4],            # middle
        [20, 69, 0], [22, 96, 2], [23, 115, 3], [24, 128, 4],         # ring
        [38, 62, 0], [42, 82, 1], [44, 96, 2], [46, 107, 3],          # pinky
    ],
    dtype=np.float64,
)

# wrist-rooted bone topology (parent, child)
HAND_BONES = tuple(
    (0 if k == 0 else 4 * f + k, 4 * f + k + 1)
    for f in range(5)
    for k in range(4)
)

# overall canonical-hand scale: keeps the rotated hand mostly inside a
# 256 px frame at z in [400, 700] with f=480 (span ~90 mm after scaling)
_HAND_SCALE = 0.6

# per-joint articulation jitter (mm): rendered AND labeled, so it is signal
_HAND_JITTER_MM = 8.0


def hand_joint_colors() -> np.ndarray:
    """(21, 3) uint8 colors: per-finger hues, within-finger brightness ramp."""
    base = np.array(
        [
            [235, 235, 235],  # wrist
            [235, 45, 45],    # thumb
            [45, 235, 45],    # index
            [70, 70, 235],    # middle
            [235, 235, 45],   # ring
            [235, 45, 235],   # pinky
        ],
        dtype=np.float64,
    )
    colors = [base[0]]
    for f in range(5):
        for k in range(4):
            colors.append(base[f + 1] * (0.55 + 0.15 * k))
    return np.clip(np.rint(np.array(colors)), 0, 255).astype(np.uint8)


# cuboid sizes (mm) cycled over the objects of a multi-object scene: distinct
# shapes keep the per-class 3D models (and diameters) genuinely different
_OBJECT_SIZES = ((40.0, 24.0, 110.0), (72.0, 72.0, 36.0), (96.0, 30.0, 30.0))


def generate_synthetic_colibri(
    root: str,
    num_frames: int = 20,
    image_size: Tuple[int, int] = (480, 480),
    folds=(0,),
    object_id: int = 1,
    seed: int = 0,
    val_fraction: float = 0.2,
    test_fraction: float = 0.2,
    num_objects: int = 1,
    hand_render_version: int = 2,
    render_scale: int = 1,
) -> str:
    """Write a synthetic dataset under ``root``; returns the dataset path.

    ``render_scale``: integer scale ``s`` rendering the SAME scenes at
    ``s``x the linear resolution (pass ``image_size`` scaled by ``s`` too):
    the focal length and every pixel-denominated rendering constant (splat
    radii, bone/arm sample densities, the 1/z joint-radius constant) scale
    by ``s``, while the rng draw SEQUENCE is kept identical to the
    ``render_scale=1`` dataset of the same seed (the per-frame background
    noise is drawn at base resolution and pixel-replicated).  A
    ``(512, 512), render_scale=2`` dataset therefore contains the same
    poses/hands/splits as the ``(256, 256), render_scale=1`` seed-0 dataset
    at twice the resolution — the controlled experiment for the
    "per-joint localizability at 256 px" hand-floor hypothesis
    (TRAIN_SYNTHETIC.md run-H verdict).

    ``hand_render_version``: 2 = round-3 skeleton renderer (default, keeps
    every existing seed-0 dataset bit-identical).  3 adds the cues the
    round-4 hand-error decomposition said were missing (TRAIN_SYNTHETIC.md
    run-F verdict): grip-distance hand placement (18-40 mm lateral instead
    of 40-70 — real egocentric hands hold the drill, and the hand targets
    are regressed from DRILL-anchored features), 1/z-scaled joint radii (a
    monocular size-depth cue), brighter bones, and two bright 3D
    orientation arrows from the wrist (palm +y in cyan, thumb-side +x in
    orange) so palm orientation is never ambiguous in an edge-on view.

    ``num_objects > 1`` writes a MULTI-OBJECT scene (beyond the reference,
    whose colibri generators are strictly K=1): every frame renders
    ``num_objects`` distinctly-shaped cuboids with ids ``object_id..+K-1``,
    each at its own mask pixel value (recorded in a ``mask_values.yml``
    sidecar in the scene dir), gt_{fold}.yml carrying one entry per object
    per frame.  The shared-frame layout otherwise matches LINEMOD, so the
    K>1 reader/training/eval path is exercised on real files.
    """
    rng = np.random.RandomState(seed)
    w, h = image_size
    s = int(render_scale)
    focal = 480.0 * s
    cam_k = np.array([[focal, 0.0, w / 2], [0.0, focal, h / 2], [0.0, 0.0, 1.0]])

    object_ids = [object_id + i for i in range(num_objects)]
    obj_dir = os.path.join(root, "data", f"{object_id:02d}")
    model_dir = os.path.join(root, "models")
    for sub in ("rgb", "mask", "hands"):
        os.makedirs(os.path.join(obj_dir, sub), exist_ok=True)
    os.makedirs(model_dir, exist_ok=True)

    if num_objects == 1:
        mask_values = [255]
    else:
        # distinct, widely separated pixel values (nearest-warp safe)
        step = 155 // (num_objects - 1)
        mask_values = [255 - i * step for i in range(num_objects)]

    models_info, scene_objects = {}, []
    for i, oid in enumerate(object_ids):
        model_points = _cuboid_points(size=_OBJECT_SIZES[i % len(_OBJECT_SIZES)], rng=rng)
        size = model_points.max(axis=0) - model_points.min(axis=0)
        diameter = float(np.linalg.norm(size))

        # orientation-revealing texture: color is a smooth function of the
        # model-frame position, so every pose renders distinguishably;
        # channel-rolled per object so classes are also tellable apart
        norm = (model_points - model_points.min(axis=0)) / np.maximum(size, 1e-6)
        point_colors = np.roll((40 + 200 * norm).astype(np.uint8), i, axis=1)

        # write the PLY model (ascii)
        ply_path = os.path.join(model_dir, f"obj_{oid:02d}.ply")
        with open(ply_path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {len(model_points)}\n")
            f.write("property float x\nproperty float y\nproperty float z\nend_header\n")
            for p in model_points:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")

        mins = model_points.min(axis=0)
        models_info[oid] = {
            "diameter": diameter,
            "min_x": float(mins[0]), "min_y": float(mins[1]), "min_z": float(mins[2]),
            "size_x": float(size[0]), "size_y": float(size[1]), "size_z": float(size[2]),
        }

        # the drill tip: the extreme +z point of the model (homogeneous)
        tip = model_points[np.argmax(model_points[:, 2])]
        scene_objects.append({
            "oid": oid,
            "points": model_points,
            "colors": point_colors,
            "mask_value": mask_values[i],
            "tip": [float(tip[0]), float(tip[1]), float(tip[2]), 1.0],
        })

    yml.dump(models_info, os.path.join(model_dir, "models_info.yml"))
    if num_objects > 1:
        yml.dump({o["oid"]: int(o["mask_value"]) for o in scene_objects},
                 os.path.join(obj_dir, "mask_values.yml"))

    gt, info = {}, {}
    for frame in range(num_frames):
        poses = []
        for i, obj in enumerate(scene_objects):
            rotvec = rng.normal(size=3)
            rotvec = rotvec / np.linalg.norm(rotvec) * rng.uniform(0.0, np.pi * 0.9)
            if num_objects == 1:
                tx = rng.uniform(-60, 60)
            else:
                # one lateral slot per object so nobody is fully occluded
                span = 180.0 / num_objects
                tx = rng.uniform(-90 + i * span + 8, -90 + (i + 1) * span - 8)
            trans = np.array([tx, rng.uniform(-60, 60), rng.uniform(400, 700)])
            poses.append((obj, rotvec, np_axis_angle_to_matrix(rotvec), trans))

        if s == 1:
            image = rng.randint(20, 80, size=(h, w, 3)).astype(np.uint8)
        else:
            # draw the background noise at BASE resolution so the rng draw
            # count (and thus every subsequent pose/hand draw) is identical
            # to the render_scale=1 dataset, then pixel-replicate
            base = rng.randint(20, 80, size=(h // s, w // s, 3)).astype(np.uint8)
            image = np.repeat(np.repeat(base, s, axis=0), s, axis=1)
        mask = np.zeros((h, w), np.uint8)
        # painter's algorithm at object granularity: far objects first, so a
        # nearer object overwrites both pixels AND mask values where it wins
        for obj, _, rot_mat, trans in sorted(poses, key=lambda p: -p[3][2]):
            uv, z = _project(obj["points"], rot_mat, trans, cam_k)
            _splat(image, mask, uv, z, obj["colors"], radius=3 * s,
                   mask_value=obj["mask_value"])
        # the hand attaches to the FIRST object's pose (one hand per frame,
        # reference layout); its depth arms are grounded on that object
        trans = poses[0][3]

        # synthetic hand: a 21-joint ARTICULATED skeleton near the object, in
        # METERS — the real dataset's hands/*.npy are meters (the reference
        # converts MPJPE to mm by multiplying by 1000, eval/common.py:975-981).
        # The canonical hand gets a uniform random 3D rotation (the dominant,
        # structurally readable variance source) plus per-joint jitter that is
        # rendered AND labeled (fine-grained signal).
        # lateral offset keeps most of the thin skeleton over the background
        # instead of lost inside the drill's own colored-splat texture
        ang = rng.uniform(0.0, 2 * np.pi)
        lateral_mm = (
            rng.uniform(18.0, 40.0) if hand_render_version >= 3
            else rng.uniform(40.0, 70.0)
        )
        hand_center_mm = (
            trans
            + lateral_mm * np.array([np.cos(ang), np.sin(ang), 0.0])
            + rng.normal(scale=10.0, size=3)
        )
        hand_rotvec = rng.normal(size=3)
        hand_rotvec = hand_rotvec / np.linalg.norm(hand_rotvec) * rng.uniform(0.0, np.pi)
        hand_rot = np_axis_angle_to_matrix(hand_rotvec)
        canonical = (HAND_CANONICAL_MM - HAND_CANONICAL_MM.mean(axis=0)) * _HAND_SCALE
        hand_pts_mm = (
            hand_center_mm
            + canonical @ hand_rot.T
            + rng.normal(scale=_HAND_JITTER_MM, size=(21, 3))
        )
        hand = hand_pts_mm / 1000.0

        # RENDER the hand into the frame (drawn over the drill, but NOT into
        # the object mask): joint identity must be recoverable STRUCTURALLY
        # (bones of a fixed wrist-rooted topology + widely separated
        # per-finger hues), because training applies the reference's full
        # RandAugment color stack — a fine-grained per-joint color code does
        # not survive posterize/solarize/contrast (run C's flat hand loss,
        # TRAIN_SYNTHETIC.md).  Bones are drawn first (dimmed), then the
        # depth arms, then the joints on top.
        #
        # Depth grounding: a dot alone fixes the joint's (u, v) ray but NOT
        # its z — unrecovered z jitter would leave an analytic MPJPE floor.
        # Each joint therefore also gets a 3D arm segment whose METRIC
        # length is proportional to its z offset from the drill: along
        # camera +x when the joint is FARTHER than the drill plane
        # (z_off >= 0), along camera +y when NEARER.  Because the arm is
        # defined in 3D and projected, its on-screen length transforms
        # consistently under the 6-DoF zoom/rotate augmentations (unlike a
        # brightness or fixed-pixel-size code), and z is recoverable as
        # drill_z + sign * |arm| / MM_PER_MM_OFFSET with sign = +1 for an
        # +x (rightward) arm, -1 for a +y (downward) arm.  Fixed metric
        # bone lengths additionally encode depth via projective scale.
        hand_colors = hand_joint_colors()
        bone_pts, bone_colors = [], []
        bone_dim = 0.7 if hand_render_version >= 3 else 0.45
        for parent, child in HAND_BONES:
            ts = np.linspace(0.0, 1.0, 24 * s)[:, None]
            bone_pts.append(hand_pts_mm[parent] + ts * (hand_pts_mm[child] - hand_pts_mm[parent]))
            dim = np.clip(np.rint(hand_colors[child].astype(np.float64) * bone_dim), 0, 255)
            bone_colors.append(np.repeat(dim[None, :].astype(np.uint8), 24 * s, axis=0))
        bone_pts = np.concatenate(bone_pts, axis=0)
        bone_colors = np.concatenate(bone_colors, axis=0)
        bone_uv, bone_z = _project(bone_pts, np.eye(3), np.zeros(3), cam_k)
        _splat(image, np.zeros((h, w), np.uint8), bone_uv, bone_z, bone_colors, radius=s)

        z_off_mm = hand_pts_mm[:, 2] - trans[2]
        arm_pts, arm_colors = [], []
        for j in range(21):
            length_mm = abs(z_off_mm[j]) * _ARM_MM_PER_MM_OFFSET
            axis = np.array([1.0, 0.0, 0.0]) if z_off_mm[j] >= 0 else np.array([0.0, 1.0, 0.0])
            ts = np.linspace(0.0, 1.0, 14 * s)[:, None]
            arm_pts.append(hand_pts_mm[j] + ts * axis * length_mm)
            arm_colors.append(np.repeat(hand_colors[j : j + 1], 14 * s, axis=0))
        arm_pts = np.concatenate(arm_pts, axis=0)
        arm_colors = np.concatenate(arm_colors, axis=0)
        arm_uv, arm_z = _project(arm_pts, np.eye(3), np.zeros(3), cam_k)
        _splat(image, np.zeros((h, w), np.uint8), arm_uv, arm_z, arm_colors, radius=s - 1)
        if hand_render_version >= 3:
            # palm-orientation arrows: 3D segments from the wrist along the
            # rotated canonical +y (finger direction, cyan) and +x
            # (thumb side, orange).  Rendered from 3D so they transform
            # consistently under the 6-DoF train-time warp; they remove the
            # palm-orientation ambiguity of near-edge-on skeleton views
            # (round-4 decomposition: error grows with lever arm from the
            # palm — an orientation-error signature).
            for axis_vec, col in (
                (np.array([0.0, 1.0, 0.0]), np.array([0, 255, 255], np.uint8)),
                (np.array([1.0, 0.0, 0.0]), np.array([255, 128, 0], np.uint8)),
            ):
                ts = np.linspace(0.0, 1.0, 18 * s)[:, None]
                seg = hand_pts_mm[0] + ts * (hand_rot @ (axis_vec * 50.0))
                seg_uv, seg_z = _project(seg, np.eye(3), np.zeros(3), cam_k)
                _splat(image, np.zeros((h, w), np.uint8), seg_uv, seg_z,
                       np.repeat(col[None, :], 18 * s, axis=0), radius=s)
        hand_uv, hand_z = _project(hand_pts_mm, np.eye(3), np.zeros(3), cam_k)
        joint_radius = (
            np.clip(np.rint(1400.0 * s / hand_z), s, 4 * s).astype(int)
            if hand_render_version >= 3 else 2 * s
        )
        _splat(image, np.zeros((h, w), np.uint8), hand_uv, hand_z, hand_colors,
               radius=joint_radius)

        write_png(os.path.join(obj_dir, "rgb", f"{frame:06d}.png"), image)
        write_png(os.path.join(obj_dir, "mask", f"{frame:06d}.png"), mask)
        np.save(os.path.join(obj_dir, "hands", f"{frame:06d}_coords_3d.npy"), hand)

        gt[frame] = [
            {
                "cam_R_m2c": [float(x) for x in rmat.reshape(-1)],
                "cam_t_m2c": [float(x) for x in tr],
                "obj_bb": [0, 0, 1, 1],  # unused; bbox comes from the mask
                "obj_id": obj["oid"],
                "drill_tip_transform": obj["tip"],
            }
            for obj, _, rmat, tr in poses
        ]
        info[frame] = {"cam_K": [float(x) for x in cam_k.reshape(-1)], "depth_scale": 1.0}

    ids = list(range(num_frames))
    rng.shuffle(ids)
    n_test = max(1, int(num_frames * test_fraction))
    n_val = max(1, int(num_frames * val_fraction))
    splits = {
        "test": ids[:n_test],
        "val": ids[n_test: n_test + n_val],
        "train": ids[n_test + n_val:],
    }

    for fold in folds:
        yml.dump(gt, os.path.join(obj_dir, f"gt_{fold}.yml"))
        yml.dump(info, os.path.join(obj_dir, f"info_{fold}.yml"))
        for name, frame_ids in splits.items():
            with open(os.path.join(obj_dir, f"{name}_{fold}.txt"), "w") as f:
                f.write("\n".join(f"{i:06d}" for i in sorted(frame_ids)) + "\n")

    return root
