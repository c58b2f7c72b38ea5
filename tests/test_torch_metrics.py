"""The port's min distances and pose metrics against the JAX package.

* ``min_distances_reference`` (the plain version the CPU runs) against the JAX
  package's Pallas kernel in interpret mode and its jnp ``min_distances``,
  within 1e-5 relative (float32 arithmetic in another order).
* ``add_s_batch`` on the CPU against the JAX package's two ADD-S paths: its
  float64 numpy loop within 1e-3 mm, and its batched device function run on
  the CPU within 1e-4 mm; the flags equal.
* The other checkers and ``compute_average_precision``: exactly equal.
* The CUDA kernel itself is held to the plain version by
  ``tests/test_torch_cuda.py``, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmd_ego_pose_tpu.eval import metrics as jax_metrics
from hmd_ego_pose_tpu.ops import distances as jax_distances
from hmd_ego_pose_tpu.ops.geometry import np_axis_angle_to_matrix
from hmd_ego_pose_tpu.ops.iou import iou_matrix_np as jax_iou_np
from hmd_ego_pose_tpu.ops.pallas_kernels import min_distances_pallas
from hmd_ego_pose_tpu_torch.eval import metrics
from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
from hmd_ego_pose_tpu_torch.ops import distances
from hmd_ego_pose_tpu_torch.ops.iou import iou_matrix_np

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _points(rng, n, center):
    return (rng.uniform(-60, 60, size=(n, 3)) + center).astype(np.float32)


@pytest.mark.parametrize("p,q", [(700, 513), (1, 1), (600, 600)])
def test_min_distances_reference_matches_jax(p, q):
    rng = np.random.default_rng(p + q)
    center = np.array([10.0, -20.0, 550.0])
    g, pr = _points(rng, p, center), _points(rng, q, center)
    g[: min(p, q) // 3] = pr[: min(p, q) // 3]  # exact zeros
    got = distances.min_distances_reference(T(g)[None], T(pr)[None])[0].numpy()
    for want in (np.asarray(min_distances_pallas(jnp.asarray(g), jnp.asarray(pr), interpret=True)),
                 np.asarray(jax_distances.min_distances(jnp.asarray(g), jnp.asarray(pr)))):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_min_distances_cpu_path_is_the_plain_version_and_launches_nothing():
    rng = np.random.default_rng(0)
    g = T(rng.normal(size=(5, 40, 3)).astype(np.float32) * 100)
    p = T(rng.normal(size=(5, 33, 3)).astype(np.float32) * 100)
    LAUNCHES.reset()
    assert torch.equal(distances.min_distances(g, p), distances.min_distances_reference(g, p))
    assert LAUNCHES.get("min_distances") == 0
    # pairs taken a few at a time give the same bits as all at once
    small = distances._REFERENCE_ELEMENTS
    try:
        distances._REFERENCE_ELEMENTS = 40 * 33 * 2
        assert torch.equal(distances.min_distances_reference(g, p), distances.min_distances(g, p))
    finally:
        distances._REFERENCE_ELEMENTS = small


@pytest.mark.parametrize("bad", [
    lambda g, p: (g.double(), p),
    lambda g, p: (g[0], p[0]),
    lambda g, p: (g, p[:2]),
    lambda g, p: (g, p[:, :0]),
    lambda g, p: (g[..., :2], p),
])
def test_min_distances_refuses_bad_inputs(bad):
    g, p = torch.zeros(3, 4, 3), torch.zeros(3, 5, 3)
    with pytest.raises(ValueError):
        distances.min_distances(*bad(g, p))


def test_min_distances_refuses_tensors_off_cpu_and_cuda():
    with pytest.raises(ValueError, match="CUDA"):
        distances.min_distances(torch.zeros(1, 2, 3, device="meta"), torch.zeros(1, 2, 3, device="meta"))


def test_paired_distances_matches_jax():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(4, 50, 3)).astype(np.float32), rng.normal(size=(4, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(distances.paired_distances(T(a), T(b)).numpy(),
                               np.asarray(jax_distances.paired_distances(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)


def _poses(rng, n):
    poses = []
    for _ in range(n):
        rg = np_axis_angle_to_matrix(rng.normal(size=3))
        tg = np.array([rng.uniform(-60, 60), rng.uniform(-60, 60), rng.uniform(400, 700)])
        rp = np_axis_angle_to_matrix(np.asarray(rng.normal(size=3)) * 0.05) @ rg
        tp = tg + rng.normal(scale=15.0, size=3)
        poses.append((rg, tg, rp, tp))
    return poses


@pytest.mark.parametrize("n_points,max_points", [(600, 1000), (2500, 1000), (300, 100)])
def test_add_s_batch_matches_both_jax_paths(n_points, max_points):
    rng = np.random.default_rng(n_points)
    model = rng.uniform(-50, 50, size=(n_points, 3)) * np.array([0.4, 0.24, 1.1])
    diameter = float(np.linalg.norm(model.max(0) - model.min(0)))
    poses = _poses(rng, 40)
    flags, means = metrics.add_s_batch(model, diameter, poses, 0.1, max_points, "cpu")

    loop = [jax_metrics.check_add_s(model, diameter, *pose, 0.1, max_points) for pose in poses]
    np.testing.assert_allclose(means, [m for _, m in loop], rtol=0, atol=1e-3)
    assert flags == [f for f, _ in loop]
    assert 0 < sum(flags) < len(flags)

    step = n_points // max_points + 1
    sub = np.ascontiguousarray(model[::step], np.float32)
    stack = [np.stack([np.reshape(pose[k], shape) for pose in poses]).astype(np.float32)
             for k, shape in ((0, (3, 3)), (1, (3,)), (2, (3, 3)), (3, (3,)))]
    device_means = np.asarray(jax_metrics._add_s_device_fn(sub.shape[0], len(poses))(sub, *stack))
    np.testing.assert_allclose(means, device_means, rtol=0, atol=1e-4)
    assert flags == [bool(m <= 0.1 * diameter) for m in device_means]
    assert metrics.add_s_batch(model, diameter, [], 0.1, max_points, "cpu") == ([], [])


def test_other_checkers_equal_jax():
    rng = np.random.default_rng(7)
    model = rng.uniform(-50, 50, size=(600, 3))
    cam = np.array([[480.0, 0, 128], [0, 480.0, 128], [0, 0, 1]])
    for rg, tg, rp, tp in _poses(rng, 25):
        tip = np.array([1.0, 2.0, 55.0, 1.0])
        assert metrics.check_add(model, 119.0, rg, tg, rp, tp) == jax_metrics.check_add(model, 119.0, rg, tg, rp, tp)
        assert metrics.check_add_s(model, 119.0, rg, tg, rp, tp) == \
            jax_metrics.check_add_s(model, 119.0, rg, tg, rp, tp)
        assert metrics.check_5cm_5degree(rg, tg, rp, tp, tip) == jax_metrics.check_5cm_5degree(rg, tg, rp, tp, tip)
        assert metrics.check_2d_reprojection(model, rg, tg, rp, tp, cam) == \
            jax_metrics.check_2d_reprojection(model, rg, tg, rp, tp, cam)
        assert metrics.rotation_diff_degrees(rg, rp) == jax_metrics.rotation_diff_degrees(rg, rp)
        assert metrics.translation_diff(tg, tp) == jax_metrics.translation_diff(tg, tp)
        hands = rng.normal(size=(2, 21, 3)) * 0.1
        assert metrics.hand_mpjpe_mm(hands[0], hands[1]) == jax_metrics.hand_mpjpe_mm(hands[0], hands[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_average_precision_equals_jax(seed):
    rng = np.random.default_rng(seed)
    tp = np.cumsum(rng.integers(0, 2, size=30).astype(float))
    fp = np.cumsum(rng.integers(0, 2, size=30).astype(float))
    recall, precision = tp / 40, tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    assert metrics.compute_average_precision(recall, precision) == \
        jax_metrics.compute_average_precision(recall, precision)


def test_iou_matrix_np_equals_jax():
    rng = np.random.default_rng(3)
    a = np.sort(rng.uniform(0, 256, size=(20, 2, 2)), axis=1).reshape(20, 4)[:, [0, 2, 1, 3]]
    b = np.concatenate([a[:5] + 3.0, np.zeros((1, 4))])
    np.testing.assert_array_equal(iou_matrix_np(a, b), jax_iou_np(a, b))

