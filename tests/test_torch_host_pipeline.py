"""The port's host input pipeline against the JAX package's, bit for bit.

Everything on the host path is numpy on an ``np.random.RandomState``, so for
the same seed the two packages draw the same numbers and must compute the
same bits:

* the warp (``data/image.py::warp_affine``) over many seeded images, angles,
  scales and centres, bilinear on RGB frames and nearest on masks: the port's
  compiled copy of the C++ warp equals the JAX package's C++ warp, and the
  port's numpy version equals the JAX package's numpy version.  The C++ and
  numpy versions of either package differ from each other at rounding
  ties: at scale 2 about the origin every other odd column and row of the
  nearest warp (a source coordinate k + 0.5 with k even: ``lround`` gives
  k + 1, ``np.round`` k); over the seeded random warps, in a handful of
  pixels, recorded in ``test_warp_matches_both_jax_paths``;
* each of the 14 colour ops, ``ColorAugmenter`` and ``random_6dof_params``;
* ``augment_6dof`` with per-object mask values, including an object that
  leaves the frame (its row is dropped) and a warp that loses every object
  (the input comes back, not valid);
* ``InputPipeline.batches``: the ``Batch`` (augmented and preprocessed on the
  host) and the ``RawBatch`` (for the device augmentation) of every step of
  an epoch, for one and two objects, augmentation on and off, with worker
  threads on the port's side and none on the JAX package's;
* the pool: a closed or failing epoch leaves no worker thread behind.
"""

import threading

import numpy as np
import pytest

from hmd_ego_pose_tpu.config import DataConfig as JaxDataConfig
from hmd_ego_pose_tpu.config import ModelConfig as JaxModelConfig
from hmd_ego_pose_tpu.data import augment as jax_augment
from hmd_ego_pose_tpu.data import image as jax_image
from hmd_ego_pose_tpu.data.colibri import ColibriDataset as JaxColibriDataset
from hmd_ego_pose_tpu.data.pipeline import InputPipeline as JaxInputPipeline
import hmd_ego_pose_tpu.serving.frameio as jax_frameio
from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.config import DataConfig
from hmd_ego_pose_tpu_torch.data import augment, image, native_warp
from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
from hmd_ego_pose_tpu_torch.data.pipeline import InputPipeline
from hmd_ego_pose_tpu_torch.ops.augment_device import Batch, RawBatch

SIZE = 128


def _numpy_warps(monkeypatch):
    """Both packages on their numpy warp: as if no C++ library could be built."""
    monkeypatch.setattr(jax_frameio, "_lib", None)
    monkeypatch.setattr(jax_frameio, "_build_failed", True)
    monkeypatch.setattr(native_warp, "_state", {"lib": None, "failed": True})


def _warp_cases(n=24):
    rng = np.random.RandomState(11)
    for i in range(n):
        h, w = rng.randint(17, 90), rng.randint(17, 90)
        frame = rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8)
        mask = np.where(rng.uniform(size=(h, w)) < 0.3, rng.choice([100, 255]), 0).astype(np.uint8)
        center = (rng.uniform(-5, w + 5), rng.uniform(-5, h + 5))
        angle = rng.uniform(0, 360) if i % 4 else float(rng.choice([0, 90, 180, -90]))
        scale = rng.uniform(0.5, 1.6) if i % 3 else float(rng.choice([0.5, 1.0, 2.0]))
        yield frame, mask, image.get_rotation_matrix_2d(center, -angle, scale), (w, h)


def _warps(warp, frame, mask, m, size):
    return warp(frame, m, size, "bilinear"), warp(mask, m, size, "nearest")


def test_warp_matches_both_jax_paths(monkeypatch):
    assert native_warp.library() is not None and jax_frameio.get_lib() is not None
    cases = list(_warp_cases())
    native = [(_warps(image.warp_affine, *c), _warps(jax_image.warp_affine, *c)) for c in cases]
    for (got_bl, got_nn), (want_bl, want_nn) in native:
        np.testing.assert_array_equal(got_bl, want_bl)
        np.testing.assert_array_equal(got_nn, want_nn)
    for c in cases:
        np.testing.assert_array_equal(image.get_rotation_matrix_2d((c[3][0] / 2, 3.0), 17.0, 1.1),
                                      jax_image.get_rotation_matrix_2d((c[3][0] / 2, 3.0), 17.0, 1.1))
    _numpy_warps(monkeypatch)
    off = {"bilinear": 0, "nearest": 0}
    for c, ((nat_bl, nat_nn), _) in zip(cases, native):
        got_bl, got_nn = _warps(image.warp_affine, *c)
        want_bl, want_nn = _warps(jax_image.warp_affine, *c)
        np.testing.assert_array_equal(got_bl, want_bl)
        np.testing.assert_array_equal(got_nn, want_nn)
        off["bilinear"] += int((got_bl != nat_bl).sum())
        off["nearest"] += int((got_nn != nat_nn).sum())
    # C++ against numpy over these 24 warps (~260,000 values): a few ties,
    # in either package alike
    assert off["bilinear"] <= 0.001 * sum(c[0].size for c in cases), off
    assert off["nearest"] <= 0.01 * sum(c[1].size for c in cases), off


def test_nearest_warp_ties_native_against_numpy(monkeypatch):
    """At scale 2 about the origin, output column x samples x / 2: a tie for
    odd x.  ``lround`` rounds k + 0.5 up, ``np.round`` to the even k: the two
    versions differ in the columns and rows x = 1 (mod 4), in both packages."""
    mask = (np.arange(40 * 40).reshape(40, 40) % 251).astype(np.uint8)
    m = image.get_rotation_matrix_2d((0.0, 0.0), 0.0, 2.0)
    native = image.warp_affine(mask, m, (40, 40), "nearest")
    np.testing.assert_array_equal(native, jax_image.warp_affine(mask, m, (40, 40), "nearest"))
    _numpy_warps(monkeypatch)
    plain = image.warp_affine(mask, m, (40, 40), "nearest")
    np.testing.assert_array_equal(plain, jax_image.warp_affine(mask, m, (40, 40), "nearest"))
    ties = (np.arange(40) % 4 == 1)
    differs = native != plain
    np.testing.assert_array_equal(differs, ties[:, None] | ties[None, :])


@pytest.mark.parametrize("op", range(len(augment.COLOR_OPS)))
def test_color_op_matches_jax(op):
    frames = np.random.RandomState(op).randint(0, 256, size=(3, 40, 56, 3)).astype(np.uint8)
    frames[1, :, :, 2] = 77  # a flat channel
    for i, (frame, m) in enumerate(zip(frames, (1, 7, 13))):
        got = augment.COLOR_OPS[op](frame, m, np.random.RandomState(100 + i))
        want = jax_augment.COLOR_OPS[op](frame, m, np.random.RandomState(100 + i))
        assert augment.COLOR_OPS[op].__name__ == jax_augment.COLOR_OPS[op].__name__
        np.testing.assert_array_equal(got, want)


def test_color_augmenter_and_6dof_params_match_jax():
    frame = np.random.RandomState(3).randint(0, 256, size=(48, 64, 3)).astype(np.uint8)
    for seed in range(20):
        got = augment.ColorAugmenter()(frame, np.random.RandomState(seed))
        want = jax_augment.ColorAugmenter()(frame, np.random.RandomState(seed))
        np.testing.assert_array_equal(got, want)
        assert augment.random_6dof_params(np.random.RandomState(seed)) == \
            jax_augment.random_6dof_params(np.random.RandomState(seed))


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """A one-object and a two-object synthetic set, 10 frames at 128 px (6 train frames)."""
    roots = {}
    for k in (1, 2):
        root = str(tmp_path_factory.mktemp(f"host{k}") / "syn")
        cli.main(["make-synthetic", "--out-dir", root, "--num-frames", "10", "--frame-size", str(SIZE),
                  "--hand-render-version", "3", "--num-objects", str(k)])
        roots[k] = root
    return roots


def _datasets(root, k):
    ids = [1, 2] if k == 2 else None
    return ColibriDataset(root, 0, 1, "train", object_ids=ids), JaxColibriDataset(root, 0, 1, "train", object_ids=ids)


def _assert_annotations_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_augment_6dof_with_mask_values_matches_jax(sets):
    tds, jds = _datasets(sets[2], 2)
    cam = tds.load_camera_matrix(0)
    frame = tds.load_image(0)
    anno_t, anno_j = tds.load_annotations(0), jds.load_annotations(0)
    assert anno_t["mask_values"].tolist() == [255, 100]
    # object 1 (255) near the top-left corner, object 2 (100) about the centre
    mask = np.zeros((SIZE, SIZE, 3), np.uint8)
    mask[2:7, 2:7] = 255
    mask[60:68, 60:68] = 100
    centre = np.array(cam)
    centre[0, 2] = centre[1, 2] = 64.0
    cases = [(33.0, 1.1, cam), (0.0, 2.0, centre), (200.0, 0.8, cam)]  # the second zooms object 1 out
    kept = []
    for angle, scale, k in cases:
        for m in (mask, tds.load_mask(0)):
            got = augment.augment_6dof(frame, m, anno_t, k, angle, scale, mask_values=anno_t["mask_values"])
            want = jax_augment.augment_6dof(frame, m, anno_j, k, angle, scale, mask_values=anno_j["mask_values"])
            np.testing.assert_array_equal(got[0], want[0])
            assert got[2] == want[2]
            _assert_annotations_equal(got[1], want[1])
            kept.append(got[1]["labels"].tolist())
    assert [0, 1] in kept and [1] in kept  # both objects kept, and object 1 dropped
    far = np.array(cam)
    far[0, 2] = far[1, 2] = 900.0
    got = augment.augment_6dof(frame, mask, anno_t, far, 45.0, 1.0, mask_values=anno_t["mask_values"])
    want = jax_augment.augment_6dof(frame, mask, anno_j, far, 45.0, 1.0, mask_values=anno_j["mask_values"])
    assert got[2] is False and want[2] is False and got[0] is frame
    _assert_annotations_equal(got[1], want[1])


CASES = [(k, aug, raw) for k in (1, 2) for aug in (True, False) for raw in (False, True) if not (raw and not aug)]


@pytest.mark.parametrize("k,aug,raw", CASES, ids=[f"k{k}-{'aug' if a else 'noaug'}-{'raw' if r else 'batch'}"
                                                   for k, a, r in CASES])
def test_host_batches_match_jax(sets, k, aug, raw):
    tds, jds = _datasets(sets[k], k)
    kw = dict(max_objects=k, use_6dof_augmentation=aug, use_colorspace_augmentation=aug, chance_no_augmentation=0.2,
              device_augment=raw, num_workers=3, prefetch=1)
    tpipe = InputPipeline(tds, DataConfig(**kw), 2, seed=7, image_size=SIZE)
    jpipe = JaxInputPipeline(jds, JaxDataConfig(**kw), JaxModelConfig(image_size=SIZE, num_classes=k), 2, seed=7)
    for oversample in (2, 1):
        got = list(tpipe.batches(oversample))
        want = list(jpipe.batches(oversample, num_workers=1))
        assert len(got) == len(want) == (len(tds) * oversample) // 2
        for g, w in zip(got, want):
            assert isinstance(g, RawBatch if raw else Batch)
            assert len(g) == len(w)
            for name, a, b in zip(g._fields, g, w):
                assert a.dtype == np.asarray(b).dtype, name
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


class _Failing:
    """A dataset whose fourth frame read raises."""

    def __init__(self, ds):
        self.ds, self.reads = ds, 0

    def __len__(self):
        return len(self.ds)

    def __getattr__(self, name):
        return getattr(self.ds, name)

    def load_image(self, i):
        self.reads += 1
        if self.reads == 4:
            raise OSError("unreadable frame")
        return self.ds.load_image(i)


def _pool_threads():
    return [t for t in threading.enumerate() if t.name.startswith("input-pipeline")]


def test_batches_pool_joins_on_close_and_on_error(sets):
    tds, _ = _datasets(sets[1], 1)
    cfg = DataConfig(num_workers=3, prefetch=2, device_augment=False, preload=False)
    gen = InputPipeline(tds, cfg, 2, seed=1, image_size=SIZE).batches(oversample=4)
    next(gen)
    gen.close()
    assert not _pool_threads()
    with pytest.raises(OSError, match="unreadable"):
        for _ in InputPipeline(_Failing(tds), cfg, 2, seed=1, image_size=SIZE).batches(oversample=4):
            pass
    assert not _pool_threads()
