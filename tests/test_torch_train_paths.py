"""The port's training paths beyond the resident one-object split, against the JAX package.

At phi-0, 128 px, batch 2, on 10-frame synthetic sets (6 train frames) with
one and with two objects per frame:

* the multi-object 6-DoF warp (``augment_6dof_batch`` at K = 2) against
  ``augment_6dof_device_multi`` run op by op, with fixed angles and scales:
  images and ``valid`` equal, labels within 1e-5 (the K = 1 tests'
  tolerance), including an object zoomed out of the frame (its row kept,
  ``valid`` cleared) and a warp that loses both (the input kept); at K = 1
  the warp is bit-identical to the one-object warp it replaced (pinned here
  as ``_one_object_warp``);
* ``augment_and_preprocess_batch`` at K = 2 with every draw taken from a JAX
  key, at the K = 1 test's tolerances;
* the windowed epoch: ``trainer.window_plan`` gives the windows and index
  rows of the JAX trainer's ``_windowed_epoch`` for a seed (and leaves the
  stream where it leaves it), ``combine_means`` its ``_combine_means``; the
  port's windowed epoch copies those windows one at a time into its one
  window buffer, in place, and its means are the windows' means weighted by
  steps;
* a budget below a batch of frames falls back to the host pipeline;
* one multi-object train step (two classes, two ground-truth rows, from
  the shipped artifact widened by ``models/weights.py::widen_classes``):
  the six losses within 1e-5 relative of the JAX package's, from the
  resident split and from a host pipeline ``Batch``; at 128 px frames and
  image size the host and device preprocess give the same batch, but for
  the rotation targets (rotation / pi, divided in float64 on the host and in
  float32 on the device: one float32 ulp apart in some values).
"""

import math
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmd_ego_pose_tpu.config import Config as JaxConfig
from hmd_ego_pose_tpu.config import DataConfig as JaxDataConfig
from hmd_ego_pose_tpu.config import ModelConfig as JaxModelConfig
from hmd_ego_pose_tpu.config import TrainConfig as JaxTrainConfig
from hmd_ego_pose_tpu.data import device_dataset as jax_device_dataset
from hmd_ego_pose_tpu.data.colibri import ColibriDataset as JaxColibriDataset
from hmd_ego_pose_tpu.data.pipeline import InputPipeline as JaxInputPipeline
from hmd_ego_pose_tpu.ops import augment_device as jax_aug
from hmd_ego_pose_tpu.train import checkpoint as jax_checkpoint
from hmd_ego_pose_tpu.train.step import _compute_losses, effective_loss_config
from hmd_ego_pose_tpu.train.trainer import Trainer as JaxTrainer
from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
from hmd_ego_pose_tpu_torch.data.device_dataset import build_host_cache
from hmd_ego_pose_tpu_torch.models.weights import widen_classes
from hmd_ego_pose_tpu_torch.ops import augment_device as aug
from hmd_ego_pose_tpu_torch.ops.geometry import axis_angle_to_matrix
from hmd_ego_pose_tpu_torch.train.checkpoint import restore_checkpoint
from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES
from hmd_ego_pose_tpu_torch.train.trainer import Trainer, combine_means, window_plan
from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger
from test_torch_augment import MAX_OFF_BY_ONE, draws_from_jax_key

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "trained", "syn1000_phi0_576ep_handrel_int8.npz")
SIZE, BATCH = 128, 2
TERMS = ("total", "classification", "regression", "rotation", "translation", "hand")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    roots = {}
    for k in (1, 2):
        root = str(tmp_path_factory.mktemp(f"paths{k}") / "syn")
        cli.main(["make-synthetic", "--out-dir", root, "--num-frames", "10", "--frame-size", str(SIZE),
                  "--hand-render-version", "3", "--num-objects", str(k)])
        roots[k] = root
    return roots


def _datasets(root, k, partition="train"):
    ids = [1, 2] if k == 2 else None
    return (ColibriDataset(root, 0, 1, partition, object_ids=ids),
            JaxColibriDataset(root, 0, 1, partition, object_ids=ids))


# ---------------------------------------------------------------------------
# the multi-object warp
# ---------------------------------------------------------------------------


def _one_object_warp(images, masks, bboxes, rotations, translations, coords_3d, valid, cx, cy, angle_deg, scale):
    """The port's one-object warp before multi-object scenes (mask value 255), kept as the K = 1 pin."""
    inv = aug.inverse_affine(-angle_deg, scale, cx, cy)
    aug_image = aug.warp_bilinear_u8(images, inv)
    aug_mask = aug.warp_nearest_u8(masks, inv)
    new_bbox, obj_valid = aug.bbox_from_mask(aug_mask == 255)
    zeros = torch.zeros_like(angle_deg)
    rot_z = axis_angle_to_matrix(torch.stack([zeros, zeros, angle_deg * (math.pi / 180.0)], dim=-1))
    rz = rot_z[:, None]
    new_rot = aug.matrix_to_axis_angle(torch.matmul(rz, axis_angle_to_matrix(rotations)))
    new_t = torch.matmul(rz, translations[..., None])[..., 0]
    new_t = torch.cat([new_t[..., :2], new_t[..., 2:] / scale[:, None, None]], dim=-1)
    new_c = torch.matmul(coords_3d, rz.transpose(-1, -2))
    new_c = torch.cat([new_c[..., :2], new_c[..., 2:] / scale[:, None, None, None]], dim=-1)
    obj_valid = obj_valid[:, None]
    keep = (obj_valid & valid).any(dim=1)

    def sel(a, b):
        return torch.where(keep.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    return aug.Augmented(sel(aug_image, images), sel(new_bbox[:, None], bboxes), sel(new_rot, rotations),
                         sel(new_t, translations), sel(new_c, coords_3d),
                         torch.where(keep[:, None], valid & obj_valid, valid), keep)


def _cache(root, k, n=4):
    return [np.asarray(a[:n]) for a in build_host_cache(_datasets(root, k)[0], k)]


def test_multi_object_warp_matches_jax(sets):
    frames, masks, cam4, boxes, rots, _, trans, coords, _, valid, mvals = _cache(sets[2], 2)
    assert mvals.tolist() == [[255, 100]] * 4 and valid.all()
    masks = masks.copy()
    masks[2] = 0  # frame 2: object 1 (255) near the top-left corner, object 2 (100) about the centre
    masks[2, 2:7, 2:7] = 255
    masks[2, 60:68, 60:68] = 100
    angles = np.array([17.5, 200.0, 0.0, 45.0], np.float32)
    scales = np.array([0.8, 1.3, 2.0, 1.0], np.float32)
    cx, cy = cam4[:, 2].copy(), cam4[:, 3].copy()
    cx[2] = cy[2] = 64.0  # zoom x2 about the centre: object 1 leaves the frame, object 2 stays
    cx[3] = cy[3] = 900.0  # a far centre: both leave, the input is kept
    want = [jax_aug.augment_6dof_device_multi(frames[i], masks[i], boxes[i], rots[i], trans[i], coords[i],
                                              mvals[i], valid[i], cx[i], cy[i], angles[i], scales[i])
            for i in range(4)]
    t = torch.from_numpy
    got = aug.augment_6dof_batch(t(frames), t(masks), t(boxes), t(rots), t(trans), t(coords), t(valid),
                                 t(cx), t(cy), t(angles), t(scales), t(mvals))
    assert got.applied.tolist() == [bool(w[6]) for w in want] == [True, True, True, False]
    assert got.valid.tolist() == [np.asarray(w[5]).tolist() for w in want]
    assert got.valid[2].tolist() == [False, True]
    np.testing.assert_array_equal(got.images.numpy(), np.stack([np.asarray(w[0]) for w in want]))
    for j, field in enumerate(("bboxes", "rotations", "translations", "coords_3d"), start=1):
        want_f = np.stack([np.asarray(w[j]) for w in want])
        np.testing.assert_allclose(getattr(got, field).numpy(), want_f, rtol=1e-5, atol=1e-5, err_msg=field)


def test_multi_object_warp_at_k1_is_the_one_object_warp(sets):
    frames, masks, cam4, boxes, rots, _, trans, coords, _, valid, mvals = map(torch.from_numpy, _cache(sets[1], 1))
    angles = torch.tensor([17.5, 200.0, 91.25, 45.0])
    scales = torch.tensor([0.7, 1.3, 1.0, 1.2])
    cx, cy = cam4[:, 2].clone(), cam4[:, 3].clone()
    cx[3] = cy[3] = 900.0
    args = (frames, masks, boxes, rots, trans, coords, valid, cx, cy, angles, scales)
    want = _one_object_warp(*args)
    assert want.applied.tolist() == [True, True, True, False]
    for values in (None, mvals):
        got = aug.augment_6dof_batch(*args, values)
        for name, a, b in zip(want._fields, got, want):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("seed", [0, 1])
def test_augment_and_preprocess_batch_k2_matches_jax(sets, seed):
    cache = _cache(sets[2], 2)
    jraw = jax_aug.RawBatch(*map(jnp.asarray, cache))
    traw = aug.RawBatch(*map(torch.from_numpy, cache))
    key = jax.random.PRNGKey(seed)
    want = jax_aug.augment_and_preprocess_batch(key, jraw, SIZE)
    got = aug.augment_and_preprocess_batch(traw, draws_from_jax_key(key, 4, SIZE, SIZE), SIZE)
    std = np.array([0.229, 0.224, 0.225], np.float32) * 255.0
    levels = np.rint((got.images.numpy() - np.asarray(want.images)) * std).astype(np.int32)
    assert np.abs(levels).max() <= 1 and float((levels != 0).mean()) <= MAX_OFF_BY_ONE
    np.testing.assert_array_equal(got.gt_labels.numpy(), np.asarray(want.gt_labels))
    np.testing.assert_array_equal(got.gt_valid.numpy(), np.asarray(want.gt_valid))
    for name in ("camera_parameters", "gt_boxes", "gt_transformation", "gt_coords_3d"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# windowed residency and the host fallback
# ---------------------------------------------------------------------------


def _jax_windows(monkeypatch, n, w, b, oversample, seed):
    """(rows, index rows) of each window the JAX trainer's ``_windowed_epoch``
    runs, and its RandomState after the epoch."""
    runs = []
    monkeypatch.setattr(jax_device_dataset, "upload_window", lambda cache, rows, mesh: rows)
    fake = SimpleNamespace(
        config=SimpleNamespace(train=SimpleNamespace(batch_size=b, oversample=oversample)),
        pipeline=SimpleNamespace(rng=np.random.RandomState(seed)),
        _host_cache=SimpleNamespace(frames=np.zeros((n, 1))), _window_frames=w, mesh=None,
        _combine_means=JaxTrainer._combine_means,
        _dispatch_scan=lambda idx, key, data: (runs.append((data, idx)), ({"loss": 1.0}, idx.shape[0]))[1])
    JaxTrainer._windowed_epoch(fake, jax.random.PRNGKey(0))
    return runs, fake.pipeline.rng


@pytest.mark.parametrize("n,w,b,oversample", [(10, 4, 2, 1), (11, 4, 3, 2), (9, 4, 3, 1), (600, 213, 16, 1)])
def test_window_plan_matches_jax(monkeypatch, n, w, b, oversample):
    want, jax_rng = _jax_windows(monkeypatch, n, w, b, oversample, seed=3)
    rng = np.random.RandomState(3)
    got = window_plan(rng, n, w, b, oversample)
    assert len(got) == len(want) >= 1
    for (rows, idx), (want_rows, want_idx) in zip(got, want):
        np.testing.assert_array_equal(rows, want_rows)
        np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(rng.randint(0, 2 ** 31 - 1, 8), jax_rng.randint(0, 2 ** 31 - 1, 8))


def test_window_plan_without_a_batch_raises_as_jax(monkeypatch):
    with pytest.raises(ValueError, match="zero steps"):
        _jax_windows(monkeypatch, 5, 2, 3, 1, seed=0)
    with pytest.raises(ValueError, match="zero steps"):
        window_plan(np.random.RandomState(0), 5, 2, 3, 1)


def test_combine_means_matches_jax():
    rng = np.random.RandomState(0)
    means = [{k: np.float32(v) for k, v in zip(METRIC_NAMES, rng.uniform(0, 100, 6))} for _ in range(3)]
    weights = [7, 7, 3]
    want = JaxTrainer._combine_means([{k: jnp.asarray(v) for k, v in m.items()} for m in means], weights)
    got = combine_means([{k: torch.tensor(v) for k, v in m.items()} for m in means], weights)
    for k in METRIC_NAMES:
        assert float(got[k]) == float(want[k]), k
    assert combine_means(means[:1], [4]) == means[0]


def _train_config(**data):
    return Config(model=ModelConfig(image_size=SIZE),
                  train=TrainConfig(batch_size=BATCH, oversample=2, checkpoint_dir="unused"),
                  data=DataConfig(num_workers=1, **data))


def test_windowed_epoch_runs_window_by_window(sets, monkeypatch):
    tds, vds = _datasets(sets[1], 1)[0], _datasets(sets[1], 1, "val")[0]
    per_frame = build_host_cache(tds, 1).bytes_per_frame()
    t = Trainer(_train_config(device_resident_budget_bytes=3 * per_frame + 100), tds, vds, device="cpu",
                logger=MetricLogger(stdout=False))
    assert t.path == "windowed" and t.window_frames == 3 and t.data is None
    plan = window_plan(np.random.RandomState(0), len(tds), 3, BATCH, 2)
    uploads, losses = [], []
    fill, buffer = t.window.fill, t.window.data.frames.data_ptr()

    def one_window(cache, rows):
        uploads.append(rows)
        data = fill(cache, rows)
        assert data.frames.data_ptr() == buffer  # the one window buffer, filled in place
        for got, field in zip(data, cache):
            np.testing.assert_array_equal(got[:len(rows)].numpy(), field[rows])
        return data

    monkeypatch.setattr(t.window, "fill", one_window)
    step = t.step_fn

    def recording(data, idx, draws, generator):
        losses.append(step(data, idx, draws, generator))
        return losses[-1]

    t.step_fn = recording
    m = t.train_epoch(0)
    assert t.windows == [3, 3] and m["steps"] == sum(len(i) for _, i in plan) == 6
    for rows, (want_rows, _) in zip(uploads, plan):
        np.testing.assert_array_equal(rows, want_rows)
    assert t.data is t.window.data and t.data.frames.shape[0] == 3
    per_window = [{k: torch.stack([s[k] for s in losses[i:i + 3]]).mean() for k in METRIC_NAMES}
                  for i in (0, 3)]
    want = combine_means(per_window, [3, 3])
    for k in METRIC_NAMES:
        assert m[k] == pytest.approx(float(want[k]), rel=1e-6) and math.isfinite(m[k]), k


def test_tiny_budget_falls_back_to_host_pipeline(sets):
    tds, vds = _datasets(sets[1], 1)[0], _datasets(sets[1], 1, "val")[0]
    t = Trainer(_train_config(device_resident_budget_bytes=1000), tds, vds, device="cpu",
                logger=MetricLogger(stdout=False))
    assert t.path == "host" and t.host_cache is None and t.data is None
    m = t.train_epoch(0)
    assert m["steps"] == len(tds) * 2 // BATCH and all(math.isfinite(m[k]) for k in METRIC_NAMES)


# ---------------------------------------------------------------------------
# one multi-object step against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def multi_step(sets):
    """The JAX package's losses of one K = 2 step from the widened artifact,
    augmentation and drop-connect off, on the sampler's first batch."""
    params, bn_state, meta = jax_checkpoint.restore_checkpoint(ARTIFACT)
    cfg = JaxConfig(model=JaxModelConfig(image_size=SIZE, num_classes=2, hand_relative=True),
                    train=JaxTrainConfig(batch_size=BATCH),
                    data=JaxDataConfig(max_objects=2, use_6dof_augmentation=False, use_colorspace_augmentation=False,
                                       preload=False))
    ds = _datasets(sets[2], 2)[1]
    data = jax_device_dataset.upload_window(jax_device_dataset.build_host_cache(ds, 2))
    idx = JaxInputPipeline(ds, cfg.data, cfg.model, BATCH, seed=0).epoch_indices(1)[0]
    batch = jax_aug.augment_and_preprocess_batch(jax.random.PRNGKey(0), jax_device_dataset.gather_raw_batch(
        data, jnp.asarray(idx)), SIZE, use_colorspace=False, use_6dof=False)
    grad_fn = jax.jit(jax.value_and_grad(_compute_losses, has_aux=True), static_argnums=(5, 6, 7))
    params = widen_classes(params, 2)
    points = ds.model_points_for_loss(cfg.train.loss.num_model_points)
    (_, (bundle, _)), _ = grad_fn(params, bn_state, batch, None, points, cfg.model, effective_loss_config(cfg),
                                  cfg.train)
    losses = [float(v) for v in (bundle.total, bundle.classification, bundle.regression, bundle.rotation,
                                 bundle.translation, bundle.hand)]
    return {"idx": idx, "losses": losses, "batch": batch}


def _multi_trainer(sets, **data):
    tds, vds = _datasets(sets[2], 2)[0], _datasets(sets[2], 2, "val")[0]
    params, bn_state, _ = restore_checkpoint(ARTIFACT, "cpu")
    cfg = Config(model=ModelConfig(image_size=SIZE, num_classes=2, hand_relative=True),
                 train=TrainConfig(batch_size=BATCH, checkpoint_dir="unused"),
                 data=DataConfig(max_objects=2, use_6dof_augmentation=False, use_colorspace_augmentation=False,
                                 num_workers=1, **data))
    return Trainer(cfg, tds, vds, device="cpu", logger=MetricLogger(stdout=False),
                   params=widen_classes(params, 2), bn_state=bn_state)


def _assert_losses(metrics, want):
    got = [float(metrics[k]) for k in METRIC_NAMES]
    for term, g, w in zip(TERMS, got, want):
        assert g == pytest.approx(w, rel=1e-5), term


def test_multi_object_step_matches_jax(sets, multi_step):
    t = _multi_trainer(sets)
    assert t.path == "resident" and t.step_fn.loss_cfg.max_positive_anchors == 128
    np.testing.assert_array_equal(t.pipeline.epoch_indices(1)[0], multi_step["idx"])
    _assert_losses(t.step_fn(t.data, torch.from_numpy(multi_step["idx"]), None, None), multi_step["losses"])


def test_multi_object_host_batch_step_matches_jax(sets, multi_step):
    t = _multi_trainer(sets, device_augment=False)
    assert t.path == "host"
    batch = next(t.pipeline.batches(oversample=1))
    assert isinstance(batch, aug.Batch)
    for name, a in zip(batch._fields, batch):  # host and device preprocess agree at 128 px -> 128 px,
        want = np.asarray(getattr(multi_step["batch"], name))  # the rotation / pi to one float32 ulp
        if name == "gt_transformation":  # (divided in float64 on the host, in float32 on the device)
            np.testing.assert_array_max_ulp(a, want, maxulp=1)
        else:
            np.testing.assert_array_equal(a, want, err_msg=name)
    _assert_losses(t.step_fn.host_step(batch, None, None), multi_step["losses"])
