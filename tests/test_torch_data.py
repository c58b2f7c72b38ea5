"""The port's dataset path against the JAX package: generator, reader, YAML, PNG, host preprocess.

* ``generate_synthetic_colibri`` of both packages, seed 0, 12 frames at
  256 px, for hand-render v2, v3 and a two-object scene: equal splits,
  pixel-equal RGB and masks, equal hand arrays, and YAML files that are
  byte-equal (and so parse equal under ``yaml.safe_load``).
* Each package's ``ColibriDataset`` reads the other package's files into
  exactly equal annotations.
* ``data/yml.py`` parses the JAX-written files (anchors and aliases) and a
  LINEMOD flow-style ``gt.yml`` as ``yaml.safe_load`` does, writes what
  ``yaml.safe_dump`` writes, and refuses what is outside its subset.
* ``read_png`` matches PIL on the generator's grayscale masks.
* The host ``preprocess_image`` is bit-equal to the JAX package's.
"""

import filecmp
import os

import numpy as np
import pytest
import yaml
from PIL import Image

from hmd_ego_pose_tpu.data import colibri as jax_colibri
from hmd_ego_pose_tpu.data import synthetic as jax_synthetic
from hmd_ego_pose_tpu.data.image import preprocess_image as jax_preprocess_image
from hmd_ego_pose_tpu.ops.geometry import matrix_to_axis_angle as jax_m2aa
from hmd_ego_pose_tpu.ops.geometry import np_axis_angle_to_matrix as jax_aa2m
from hmd_ego_pose_tpu_torch.data import colibri, synthetic, yml
from hmd_ego_pose_tpu_torch.data.image import preprocess_image, read_png, write_png
from hmd_ego_pose_tpu_torch.ops import geometry

CONFIGS = {
    "v3": dict(hand_render_version=3),
    "v2": dict(hand_render_version=2),
    "two_objects": dict(hand_render_version=3, num_objects=2),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def both_sets(request, tmp_path_factory):
    """(config name, JAX-written root, port-written root) of one generator config."""
    kw = CONFIGS[request.param]
    base = tmp_path_factory.mktemp(request.param)
    roots = []
    for name, gen in (("jax", jax_synthetic), ("torch", synthetic)):
        root = str(base / name)
        gen.generate_synthetic_colibri(root, num_frames=12, image_size=(256, 256), **kw)
        roots.append(root)
    return request.param, roots[0], roots[1]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_generators_write_the_same_dataset(both_sets):
    _, jax_root, torch_root = both_sets
    names = _files(jax_root)
    assert names == _files(torch_root)
    assert sum(n.endswith(".png") for n in names) == 24
    for rel in names:
        a, b = os.path.join(jax_root, rel), os.path.join(torch_root, rel)
        if rel.endswith(".png"):
            with Image.open(a) as im:
                want = np.asarray(im)
            with Image.open(b) as im:
                got = np.asarray(im)
            np.testing.assert_array_equal(got, want, err_msg=rel)  # RGB and grayscale masks
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(b), np.load(a), err_msg=rel)
        elif rel.endswith(".yml"):
            with open(a) as fa, open(b) as fb:
                assert yaml.safe_load(fb) == yaml.safe_load(fa), rel
            assert filecmp.cmp(a, b, shallow=False), rel  # byte-equal: the same sha256
        else:  # split txts and the PLY models
            assert filecmp.cmp(a, b, shallow=False), rel


def _dataset_kwargs(config):
    return {"object_ids": [1, 2]} if config == "two_objects" else {}


@pytest.mark.parametrize("partition", ["train", "val", "test"])
def test_readers_read_each_others_files_equally(both_sets, partition):
    config, jax_root, torch_root = both_sets
    kw = _dataset_kwargs(config)
    want = jax_colibri.ColibriDataset(jax_root, 0, 1, partition, **kw)
    for reader, root in ((colibri, jax_root), (jax_colibri, torch_root), (colibri, torch_root)):
        got = reader.ColibriDataset(root, 0, 1, partition, **kw)
        assert len(got) == len(want) > 0
        assert got.class_to_name == want.class_to_name
        assert got.class_labels_to_object_ids == want.class_labels_to_object_ids
        assert got.get_objects_diameter_dict() == want.get_objects_diameter_dict()
        for c, pts in want.get_models_3d_points_dict().items():
            np.testing.assert_array_equal(got.get_models_3d_points_dict()[c], pts)
        for i in range(len(want)):
            a, b = want.load_annotations(i), got.load_annotations(i)
            assert sorted(a) == sorted(b)
            for key in a:
                assert b[key].dtype == a[key].dtype, key
                np.testing.assert_array_equal(b[key], a[key], err_msg=key)
            np.testing.assert_array_equal(got.load_camera_matrix(i), want.load_camera_matrix(i))
            np.testing.assert_array_equal(got.load_drill_tip_offset(i), want.load_drill_tip_offset(i))
            np.testing.assert_array_equal(got.load_image(i), want.load_image(i))


def test_yml_reads_the_generators_anchors_and_aliases(both_sets):
    _, jax_root, _ = both_sets
    path = os.path.join(jax_root, "data", "01", "gt_0.yml")
    with open(path) as f:
        text = f.read()
    assert "&id001" in text and "*id001" in text
    data = yml.loads(text)
    assert data == yaml.safe_load(text)
    # an alias is the anchored object itself, as PyYAML builds it
    assert data[0][0]["drill_tip_transform"] is data[1][0]["drill_tip_transform"]
    assert yml.dumps(data) == text


LINEMOD_GT = """0:
- cam_R_m2c: [0.0963063, 0.99404401, 0.0510079, 0.57332098, -0.01370504, -0.81922001, -0.81365103, 0.10727, -0.57137799]
  cam_t_m2c: [-105.3577515, -117.52119142, 1014.8770132]
  obj_bb: [244, 150, 44, 58]
  obj_id: 1
1:
- cam_R_m2c: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
  cam_t_m2c: [1e-5, -2.5e+2, 3.0e-05]
  obj_bb: [1, 2, 3, 4]
  obj_id: 2
"""


def test_yml_reads_linemod_flow_style_gt():
    got = yml.loads(LINEMOD_GT)
    assert got == yaml.safe_load(LINEMOD_GT)
    assert got[1][0]["cam_t_m2c"] == ["1e-5", -250.0, 3.0e-05]  # YAML 1.1: no dot, no float


@pytest.mark.parametrize("data", [
    {0: {"cam_K": [480.0, 0.0, 128.0, 0.0, 480.0, 128.0, 0.0, 0.0, 1.0], "depth_scale": 1.0}},
    {1: {"diameter": 119.8, "min_x": -20.0, "size_x": 1e-17}, 2: {"diameter": 1e17}},
    {3: 255, 4: 100},
    [[1, 2], {"a": True, "b": None, "c": []}, -0.0, "plain_text"],
])
def test_yml_writes_what_safe_dump_writes(data):
    text = yml.dumps(data)
    assert text == yaml.safe_dump(data)
    assert yml.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 0x1f\n", "a: 010\n", "a: |\n  block\n", "a: 'quoted'\n", "a: {b: 1}\n",
    "a: 2001-12-14\n", "a: [1, [2]]\n", "a: 1  # comment\n", "a: *missing\n",
])
def test_yml_refuses_what_is_outside_the_subset(text):
    with pytest.raises(ValueError):
        yml.loads(text)


def test_yml_refuses_values_it_cannot_write():
    with pytest.raises(ValueError):
        yml.dumps({"a": np.float32(1.0)})
    with pytest.raises(ValueError):
        yml.dumps({"a": "needs: quoting"})


def test_read_png_matches_pil_on_masks_and_write_png_round_trips(both_sets, tmp_path):
    _, jax_root, _ = both_sets
    mask_dir = os.path.join(jax_root, "data", "01", "mask")
    for name in sorted(os.listdir(mask_dir))[:4]:
        path = os.path.join(mask_dir, name)
        with Image.open(path) as im:
            assert im.mode == "L"
            want = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(read_png(path), want)
    rng = np.random.default_rng(3)
    for image in (rng.integers(0, 256, (7, 5, 3), dtype=np.uint8), rng.integers(0, 256, (4, 9), dtype=np.uint8)):
        path = str(tmp_path / "x.png")
        write_png(path, image)
        with Image.open(path) as im:
            np.testing.assert_array_equal(np.asarray(im), image)
    with pytest.raises(ValueError):
        write_png(path, np.zeros((4, 4), np.float32))


@pytest.mark.parametrize("h,w", [(256, 256), (480, 480), (300, 300), (480, 640)])
def test_host_preprocess_bit_equal_to_jax(h, w):
    image = np.random.default_rng(h * w).integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    want, want_scale = jax_preprocess_image(image, 256)
    got, got_scale = preprocess_image(image, 256)
    assert got_scale == want_scale
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_geometry_copies_match_jax():
    rng = np.random.default_rng(0)
    rotvecs = rng.normal(size=(50, 3)) * rng.uniform(0, np.pi, size=(50, 1))
    rotvecs[0] = 0.0
    np.testing.assert_array_equal(geometry.np_axis_angle_to_matrix(rotvecs), jax_aa2m(rotvecs))
    mats = jax_aa2m(rotvecs)
    np.testing.assert_array_equal(geometry.matrix_to_axis_angle(mats), jax_m2aa(mats))


def test_subsample_and_bbox_helpers_match_jax():
    pts = np.random.default_rng(1).normal(size=(1203, 3))
    for count in (500, 1203, 2000):
        np.testing.assert_array_equal(colibri.subsample_model_points(pts, count),
                                      jax_colibri.subsample_model_points(pts, count))
    mask = np.zeros((20, 30), np.uint8)
    mask[3:7, 10:25] = 200
    mask[12, 2] = 100
    for value in (None, 200, 100, 50):
        got, want = colibri.get_bbox_from_mask(mask, value), jax_colibri.get_bbox_from_mask(mask, value)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])


def test_port_imports_only_the_standard_library_torch_numpy_and_scipy():
    import ast
    import sys

    allowed = set(sys.stdlib_module_names) | {"torch", "numpy", "scipy", "triton", "hmd_ego_pose_tpu_torch"}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(repo, "hmd_ego_pose_tpu_torch"))
             for f in fs if f.endswith(".py")] + [os.path.join(repo, "chip_smoke.py")]
    assert os.path.join(repo, "hmd_ego_pose_tpu_torch", "export", "pt2.py") in paths
    offenders = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            offenders += [f"{os.path.relpath(path, repo)}:{node.lineno} {n}" for n in names
                          if n.split(".")[0] not in allowed]
    assert not offenders, offenders
