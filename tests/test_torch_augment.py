"""The port's device augmentation against the JAX package's, with every random value fixed.

The JAX ops draw from ``jax.random`` keys; the port's ops take the drawn
values as arguments.  Each test draws the values from the JAX key exactly
as the JAX op does and hands them to the port, so both compute the same
function of the same numbers:

* each of the 13 colour ops (and the identity) on three frames at three
  magnitudes, with the cutout position and the noise fixed;
* ``augment_6dof_device`` at fixed angles and scales, including a warp that
  moves the object out of the frame (the sample falls back to its input);
* ``augment_and_preprocess_batch`` with every draw of the batch fixed;
* the fixed-shape colour pass (``color_augment_fixed``, the resident step
  graph's): bit-equal per row to the grouped ``color_augment_batch`` on
  draws that hold every op, an inactive second slot, an example not
  augmented and noise in both slots (``chip_smoke.colour_cases``), and to
  JAX's ``color_augment`` per example, its ``lax.switch`` run branch by
  branch (``jax.disable_jit``).

The JAX side runs op by op (not jitted), so each float operation is
rounded on its own, as in the port: the uint8 images are then equal, op for
op and after the warp.  The whole batch may differ by one level at a few
values (at most 0.1 %), where the float32 mean of the contrast op is summed
in another order.  Labels agree within 1e-5 (translations in mm within 1e-5
of the largest value).

Jitted, XLA:CPU fuses the ops and contracts some multiply-adds into FMAs:
then up to 0.9 % of a 3x3 filter's pixels differ by one level, and a
following autocontrast or equalize stretches such a level to three.  The
JAX train step runs jitted; these tests hold the arithmetic, not XLA's
fusion choices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hmd_ego_pose_tpu.data.colibri import ColibriDataset as JaxColibriDataset
from hmd_ego_pose_tpu.data.device_dataset import build_host_cache as jax_build_host_cache
from hmd_ego_pose_tpu.ops import augment_device as jax_aug
from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.ops import augment_device as aug

H, W = 48, 64
# the largest share of batch values allowed one level off (the contrast op's
# float32 mean, summed in another order)
MAX_OFF_BY_ONE = 0.001


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames(seed, m=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(m, H, W, 3))
    smooth = (np.cumsum(rng.integers(-3, 4, size=(m, H, W, 3)), axis=2) + 128) % 256  # gradients, long runs
    frames = np.where(rng.uniform(size=(m, H, W, 1)) < 0.5, base, smooth).astype(np.float32)
    frames[1, :, :, 2] = 77.0  # a flat channel: autocontrast / equalize keep it
    return frames




FACTOR_OPS = (aug.COLOR, aug.CONTRAST, aug.BRIGHTNESS, aug.SHARPNESS)


@pytest.mark.parametrize("op", range(aug.NUM_OPS))
def test_color_op_matches_jax(op):
    frames = _frames(op)
    mags = np.array([1.0, 7.0, 13.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(100 + op), 3)
    jax_op = jax_aug.COLOR_OP_BRANCHES[op]
    want = np.stack([np.asarray(jax_op(jnp.asarray(f), jnp.float32(m), k)) for f, m, k in zip(frames, mags, keys)])
    img, m = torch.from_numpy(frames), torch.from_numpy(mags)
    if op in FACTOR_OPS:
        r = torch.tensor([float(jax.random.uniform(k)) for k in keys])
        got = {aug.COLOR: aug.op_color, aug.CONTRAST: aug.op_contrast, aug.BRIGHTNESS: aug.op_brightness,
               aug.SHARPNESS: aug.op_sharpness}[op](img, m, r)
    elif op == aug.CUTOUT:
        yx = []
        for k in keys:
            ky, kx = jax.random.split(k)
            yx.append([int(jax.random.randint(ky, (), 0, H)), int(jax.random.randint(kx, (), 0, W))])
        got = aug.op_cutout(img, m, torch.tensor(yx))
    elif op == aug.GAUSSIAN_NOISE:
        noise = np.stack([np.asarray(jax.random.normal(k, (H, W, 3))) for k in keys])
        got = aug.op_gaussian_noise(img, m, torch.from_numpy(noise))
    elif op == aug.IDENTITY:
        got = img
    else:
        got = {aug.AUTOCONTRAST: aug.op_autocontrast, aug.EQUALIZE: aug.op_equalize, aug.INVERT: aug.op_invert,
               aug.POSTERIZE: aug.op_posterize, aug.SOLARIZE: aug.op_solarize, aug.BLUR: aug.op_blur,
               aug.SMOOTH: aug.op_smooth}[op](img, m)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def frames_and_labels(tmp_path_factory):
    """Four frames of a 128 px synthetic set with their masks and labels (host cache layout)."""
    root = str(tmp_path_factory.mktemp("aug") / "syn")
    cli.main(["make-synthetic", "--out-dir", root, "--num-frames", "6", "--frame-size", "128",
              "--hand-render-version", "3"])
    cache = jax_build_host_cache(JaxColibriDataset(root, 0, 1, "train"), 1)
    return [np.asarray(a[:4]) for a in cache]


def _raw_batches(cache):
    frames, masks, cam4, boxes, rots, is_sym, trans, coords, labels, valid, mask_values = cache
    jraw = jax_aug.RawBatch(*map(jnp.asarray, (frames, masks, cam4, boxes, rots, is_sym, trans, coords, labels,
                                               valid, mask_values)))
    traw = aug.RawBatch(*map(torch.from_numpy, (frames, masks, cam4, boxes, rots, is_sym, trans, coords, labels,
                                                valid, mask_values)))
    return jraw, traw


def test_augment_6dof_matches_jax(frames_and_labels):
    frames, masks, cam4, boxes, rots, _, trans, coords, _, valid, _ = frames_and_labels
    angles = np.array([17.5, 200.0, 91.25, 45.0], np.float32)
    scales = np.array([0.7, 1.3, 1.0, 1.2], np.float32)
    cx, cy = cam4[:, 2].copy(), cam4[:, 3].copy()
    cx[3] = cy[3] = 900.0  # rotating about a far centre moves the object out: the input is kept
    fn = jax_aug.augment_6dof_device
    want = [fn(frames[i], masks[i], boxes[i, 0], rots[i, 0], trans[i, 0], coords[i, 0], cx[i], cy[i],
               angles[i], scales[i]) for i in range(4)]
    t = torch.from_numpy
    got = aug.augment_6dof_batch(t(frames), t(masks), t(boxes), t(rots), t(trans), t(coords), t(valid),
                                 t(cx), t(cy), t(angles), t(scales))
    assert [bool(w.applied) for w in want] == got.applied.tolist() == [True, True, True, False]
    np.testing.assert_array_equal(got.images.numpy(), np.stack([np.asarray(w.image) for w in want]))
    for name, field in (("bbox", "bboxes"), ("rotation", "rotations"), ("translation", "translations"),
                        ("coords_3d", "coords_3d")):
        want_f = np.stack([np.asarray(getattr(w, name)) for w in want])
        np.testing.assert_allclose(getattr(got, field)[:, 0].numpy(), want_f, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def draws_from_jax_key(key, b, h, w, chance=0.02, scale_range=(0.7, 1.3)) -> aug.AugmentDraws:
    """The values ``augment_and_preprocess_batch`` of the JAX package draws from ``key``."""
    keys = jax.random.split(key, b * 4).reshape(b, 4, 2)
    apply, n, ops, mags, factors, yx, angles, scales, noise = [], [], [], [], [], [], [], [], {}
    for i in range(b):
        k_apply, k_color, k_angle, k_scale = keys[i]
        apply.append(bool(jax.random.uniform(k_apply) >= chance))
        k_n, k_ops, k_mags, k_inner = jax.random.split(k_color, 4)
        n.append(int(jax.random.randint(k_n, (), 1, 3)))
        ops.append(np.asarray(jax.random.randint(k_ops, (2,), 0, aug.NUM_OPS)))
        mags.append(np.asarray(jax.random.randint(k_mags, (2,), 1, 14)))
        inner = jax.random.split(k_inner, 2)
        factors.append([float(jax.random.uniform(k)) for k in inner])
        slot_yx = []
        for k in inner:
            ky, kx = jax.random.split(k)
            slot_yx.append([int(jax.random.randint(ky, (), 0, h)), int(jax.random.randint(kx, (), 0, w))])
        yx.append(slot_yx)
        for slot in range(2):
            if apply[-1] and slot < n[-1] and ops[-1][slot] == aug.GAUSSIAN_NOISE:
                noise.setdefault(slot, []).append(np.asarray(jax.random.normal(inner[slot], (h, w, 3))))
        angles.append(float(jax.random.uniform(k_angle) * 360.0))
        scales.append(float(jax.random.uniform(k_scale) * (scale_range[1] - scale_range[0]) + scale_range[0]))
    return aug.AugmentDraws(
        torch.tensor(apply), torch.tensor(n), torch.tensor(np.stack(ops)).long(),
        torch.tensor(np.stack(mags)).long(), torch.tensor(factors), torch.tensor(yx),
        {s: torch.from_numpy(np.stack(v)) for s, v in noise.items()},
        torch.tensor(angles, dtype=torch.float32), torch.tensor(scales, dtype=torch.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_and_preprocess_batch_matches_jax(frames_and_labels, seed):
    jraw, traw = _raw_batches(frames_and_labels)
    key = jax.random.PRNGKey(seed)
    want = jax_aug.augment_and_preprocess_batch(key, jraw, 128)
    draws = draws_from_jax_key(key, 4, 128, 128)
    got = aug.augment_and_preprocess_batch(traw, draws, 128)
    # back to uint8 levels: x * std * 255 + mean * 255
    std = np.array([0.229, 0.224, 0.225], np.float32) * 255.0
    levels = np.rint((got.images.numpy() - np.asarray(want.images)) * std).astype(np.int32)
    assert np.abs(levels).max() <= 1 and float((levels != 0).mean()) <= MAX_OFF_BY_ONE
    np.testing.assert_allclose(got.camera_parameters.numpy(), np.asarray(want.camera_parameters), rtol=1e-6)
    np.testing.assert_array_equal(got.gt_labels.numpy(), np.asarray(want.gt_labels))
    np.testing.assert_array_equal(got.gt_valid.numpy(), np.asarray(want.gt_valid))
    for name in ("gt_boxes", "gt_transformation", "gt_coords_3d"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_draw_augment_distributions():
    g = torch.Generator().manual_seed(0)
    d = aug.draw_augment(g, 4000, 20, 30, chance_no_augmentation=0.25, scale_range=(0.5, 2.0))
    assert abs(float(d.apply.float().mean()) - 0.75) < 0.03
    assert set(d.n_slots.tolist()) == {1, 2} and set(d.op_ids.reshape(-1).tolist()) == set(range(14))
    assert set(d.magnitudes.reshape(-1).tolist()) == set(range(1, 14))
    assert d.cutout_yx[..., 0].max() == 19 and d.cutout_yx[..., 1].max() == 29 and d.cutout_yx.min() == 0
    assert 0.5 <= float(d.scales.min()) and float(d.scales.max()) < 2.0 and float(d.angles.max()) < 360.0
    for slot in range(2):
        assert d.noise[slot].shape[0] == aug.slot_ops(d, slot).count(aug.GAUSSIAN_NOISE)
    again = aug.draw_augment(torch.Generator().manual_seed(0), 4000, 20, 30, 0.25, (0.5, 2.0))
    assert torch.equal(again.op_ids, d.op_ids) and torch.equal(again.noise[0], d.noise[0])


@pytest.mark.parametrize("h,w", [(64, 64), (256, 256)])
def test_color_augment_fixed_equals_grouped_per_row(h, w):
    frames, draws = chip_smoke.colour_cases(h, w, seed=h)
    ops = [aug.slot_ops(draws, slot) for slot in range(aug.MAX_SLOTS)]
    assert set(ops[0]) == set(range(aug.NUM_OPS)) and ops[1][3] == ops[1][7] == aug.IDENTITY
    assert all(draws.noise[slot].shape[0] == 3 for slot in range(aug.MAX_SLOTS))
    want = aug.color_augment_batch(frames, draws)
    got = aug.color_augment_fixed(frames, aug.slot_draws(draws, h, w))
    assert torch.equal(got, want)
    assert torch.equal(got[5], frames[5])  # not augmented


@pytest.mark.parametrize("seed", [0, 1])
def test_color_augment_fixed_matches_jax(seed):
    b, h, w = 16, H, W
    key = jax.random.PRNGKey(seed)
    draws = draws_from_jax_key(key, b, h, w, chance=0.2)
    frames = _frames(seed, b).astype(np.uint8)
    keys = jax.random.split(key, b * 4).reshape(b, 4, 2)
    with jax.disable_jit():  # lax.switch runs the drawn branch, op by op
        want = np.stack([np.asarray(jax_aug.color_augment(jnp.asarray(f), k[1])) if on else f
                         for f, k, on in zip(frames, keys, draws.apply.tolist())])
    got = aug.color_augment_fixed(torch.from_numpy(frames), aug.slot_draws(draws, h, w))
    np.testing.assert_array_equal(got.numpy(), want)
