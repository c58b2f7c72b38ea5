"""The port's ``data/format_labels.py`` and ``cli format-labels`` against the JAX package's.

* ``binarize_mask``, ``bbox_from_mask``, ``pose_from_affine`` and the tip
  rule on seeded inputs: exactly equal (the same float64 operations).
* ``convert_pickles`` of both packages on the same pickles (general
  rotations, a corrupt frame, every tip form, both camera keys), with the
  default 60/20/20 split or given splits, other folds and skipped frames:
  the same files; YAML, split files and ``.npy`` byte-equal; PNGs
  pixel-equal (the encoders differ).  Each package's reader reads the other
  package's output into equal annotations.
* ``cli format-labels`` of ``chip_smoke.label_pickles`` (the card's input,
  at 64 px here) in both packages: equal ``chip_smoke.tree_digests``; an
  empty directory is refused by both.
"""

import filecmp
import os
import pickle

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from hmd_ego_pose_tpu import cli as jax_cli
from hmd_ego_pose_tpu.data import colibri as jax_colibri
from hmd_ego_pose_tpu.data import format_labels as jax_fl
from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.data import colibri, yml
from hmd_ego_pose_tpu_torch.data import format_labels as fl


def _rotation(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.sqrt(q @ q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def write_pickles(directory, frames=6, size=(60, 80), seed=2):
    rng = np.random.RandomState(seed)
    tips = (lambda: np.array([*rng.uniform(-0.3, 0.3, 3), 1.0]), lambda: rng.uniform(-0.3, 0.3, 3),
            lambda: np.array([*rng.uniform(-300, 300, 3), 1.0]), lambda: rng.uniform(-0.3, 0.3, (4, 1)))
    paths = []
    for i in range(frames):
        mask = rng.randint(0, 11, size=(*size, 3)).astype(np.uint8)
        if i != 3:  # frame 3 is corrupt: an empty mask
            mask[10 + i:40, 20:50 + i, 0] = 200
        affine = np.concatenate([_rotation(rng), rng.normal(scale=0.1, size=(3, 1)) + [[0], [0], [0.5]]], axis=1)
        record = {"rgb": rng.randint(0, 256, size=(*size, 3)).astype(np.uint8),
                  "mask": mask if i % 2 else mask[..., 0],
                  "affine_transform": affine if i % 2 else np.concatenate([affine, [[0, 0, 0, 1]]]),
                  "cam_calib" if i % 3 else "camera_matrix": np.array([[140.0, 0, 40], [0, 140.0, 30], [0, 0, 1]]),
                  "coords_3d": rng.normal(scale=0.05, size=(21, 3)),
                  "drill_tip_transform": tips[i % 4]()}
        paths.append(os.path.join(directory, f"{i:05d}.pkl"))
        with open(paths[-1], "wb") as f:
            pickle.dump(record, f)
    return paths


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def assert_same_tree(jax_root, port_root):
    names = _files(jax_root)
    assert names == _files(port_root)
    for rel in names:
        a, b = os.path.join(jax_root, rel), os.path.join(port_root, rel)
        if rel.endswith(".png"):
            with Image.open(a) as ia, Image.open(b) as ib:
                assert ia.mode == ib.mode, rel
                np.testing.assert_array_equal(np.asarray(ib), np.asarray(ia), err_msg=rel)
        else:  # YAML, split txts and npy
            assert filecmp.cmp(a, b, shallow=False), rel
    return names


def test_helpers_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        mask = rng.randint(0, 30, size=(12, 9, 3)).astype(np.uint8)
        for m in (mask, mask[..., 0], np.zeros_like(mask)):
            b = fl.binarize_mask(m)
            np.testing.assert_array_equal(b, jax_fl.binarize_mask(m))
            got, want = fl.bbox_from_mask(b), jax_fl.bbox_from_mask(b)
            assert (got is None and want is None) or (np.array_equal(got, want) and got.dtype == want.dtype)
        affine = np.concatenate([_rotation(rng), rng.normal(size=(3, 1))], axis=1)
        for a, b in zip(fl.pose_from_affine(affine), jax_fl.pose_from_affine(affine)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fl.MODEL_RECENTER_OFFSET_M, jax_fl.MODEL_RECENTER_OFFSET_M)


@pytest.mark.parametrize("kwargs", [
    {},
    {"splits": {"train": [0, 1], "val": [2], "test": [4, 5]}},
    {"fold": 2, "object_id": 3, "skip_frames": (1,)},
], ids=["default_splits", "given_splits", "fold2_object3_skip"])
def test_convert_pickles_matches_jax_file_for_file(tmp_path, kwargs):
    paths = write_pickles(str(tmp_path))
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_fl.convert_pickles(paths, jax_root, **kwargs) == jax_root
    assert fl.convert_pickles(paths, port_root, **kwargs) == port_root
    names = assert_same_tree(jax_root, port_root)
    oid, fold = kwargs.get("object_id", 1), kwargs.get("fold", 0)
    assert f"data/{oid:02d}/gt_{fold}.yml" in names and f"data/{oid:02d}/rgb/000003.png" not in names

    for root in (jax_root, port_root):  # a model dir for the readers
        os.makedirs(os.path.join(root, "models"))
        with open(os.path.join(root, "models", f"obj_{oid:02d}.ply"), "w") as f:
            f.write("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\nproperty float y\n"
                    "property float z\nend_header\n0 0 0\n1 0 0\n0 1 0\n")
        yml.dump({oid: {"diameter": 100.0, "min_x": 0.0, "min_y": 0.0, "min_z": 0.0, "size_x": 1.0,
                        "size_y": 1.0, "size_z": 1.0}}, os.path.join(root, "models", "models_info.yml"))
    want = jax_colibri.ColibriDataset(jax_root, fold=fold, object_id=oid, partition="train")
    got = colibri.ColibriDataset(port_root, fold=fold, object_id=oid, partition="train")
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        a, b = want.load_annotations(i), got.load_annotations(i)
        for key in a:
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)


def test_cli_format_labels_matches_jax(tmp_path):
    pickles = str(tmp_path / "pickles")
    os.makedirs(pickles)
    chip_smoke.label_pickles(pickles, size=64)
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_cli.main(["format-labels", "--in-dir", pickles, "--out-dir", jax_out])
    assert cli.main(["format-labels", "--in-dir", pickles, "--out-dir", port_out]) == port_out
    digests = chip_smoke.tree_digests(port_out)
    assert digests == chip_smoke.tree_digests(jax_out)
    assert len(digests) == 5 + 3 * (chip_smoke.LABEL_FRAMES - 1)  # two YAMLs, three splits, 7 kept frames
    assert_same_tree(jax_out, port_out)

    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for main in (jax_cli.main, cli.main):
        with pytest.raises(SystemExit, match="no .pkl"):
            main(["format-labels", "--in-dir", empty, "--out-dir", str(tmp_path / "none")])
