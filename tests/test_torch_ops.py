"""The port's anchors, decode, detection filter and preprocess against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmd_ego_pose_tpu.config import AnchorConfig as JaxAnchorConfig
from hmd_ego_pose_tpu.ops import anchors as jax_anchors
from hmd_ego_pose_tpu.ops import decode as jax_decode
from hmd_ego_pose_tpu.ops.iou import iou_matrix as jax_iou_matrix
from hmd_ego_pose_tpu.ops.nms import filter_detections_fused_batch as jax_filter
from hmd_ego_pose_tpu.ops.preprocess import preprocess_uint8_batch as jax_preprocess
from hmd_ego_pose_tpu_torch.config import AnchorConfig
from hmd_ego_pose_tpu_torch.ops import anchors, decode, nms
from hmd_ego_pose_tpu_torch.ops.preprocess import preprocess_uint8_batch

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("size", [128, 256, 512])
def test_anchors_bit_equal_to_jax(size):
    want_boxes, want_trans = jax_anchors.anchors_for_shape((size, size), JaxAnchorConfig())
    got_boxes, got_trans = anchors.anchors_for_shape((size, size), AnchorConfig())
    np.testing.assert_array_equal(got_boxes, want_boxes)
    np.testing.assert_array_equal(got_trans, want_trans)
    assert got_boxes.shape[0] == AnchorConfig().num_anchors(size)


def test_decode_matches_jax():
    rng = np.random.default_rng(0)
    anc, tanc = anchors.anchors_for_shape((256, 256), AnchorConfig())
    deltas = rng.normal(scale=0.3, size=(2,) + anc.shape).astype(np.float32)
    raw = np.concatenate([rng.normal(size=(2, anc.shape[0], 2)),
                          rng.uniform(0.2, 2.0, size=(2, anc.shape[0], 1))], axis=-1).astype(np.float32)
    cams = np.array([[480, 480, 128, 128, 1000, 1.0], [572.4, 573.6, 120, 130, 1000, 0.5]], np.float32)

    want = jax_decode.clip_boxes(jax_decode.bbox_transform_inv(jnp.asarray(anc)[None], jnp.asarray(deltas)), 256, 256)
    got = decode.clip_boxes(decode.bbox_transform_inv(T(anc.copy())[None], T(deltas)), 256, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)

    want_t = jax_decode.decode_translation(jnp.asarray(tanc)[None], jnp.asarray(raw), jnp.asarray(cams))
    got_t = decode.decode_translation(T(tanc.copy())[None], T(raw), T(cams))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-6, atol=1e-4)

    hand = rng.normal(size=(2, 5, 63)).astype(np.float32)
    tr = rng.normal(scale=500, size=(2, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(decode.hand_to_absolute(T(hand), T(tr)).numpy(),
                                  np.asarray(jax_decode.hand_to_absolute(jnp.asarray(hand), jnp.asarray(tr))))


def test_iou_matrix_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 200, size=(23, 4)).astype(np.float32)
    a[:, 2:] = a[:, :2] + rng.uniform(0, 60, size=(23, 2))
    a[0, 2:] = a[0, :2]  # a box of zero area: union of two such boxes is 0 -> IoU 0
    np.testing.assert_allclose(nms.iou_matrix(T(a), T(a)).numpy(),
                               np.asarray(jax_iou_matrix(jnp.asarray(a), jnp.asarray(a))), rtol=1e-6, atol=1e-7)


def _raw_heads(rng, b, n, c, tied):
    anc = rng.uniform(0, 200, size=(n, 4)).astype(np.float32)
    anc[:, 2:] = anc[:, :2] + rng.uniform(8, 60, size=(n, 2))
    tanc = np.concatenate([rng.uniform(0, 256, size=(n, 2)), np.full((n, 1), 8.0)], axis=1).astype(np.float32)
    cls = rng.uniform(0, 1, size=(b, n, c)).astype(np.float32)
    if tied:  # coarse score levels: many exact ties, in top-k and between classes
        cls = np.round(cls * 6) / 6
    heads = dict(
        regression=rng.normal(scale=0.3, size=(b, n, 4)).astype(np.float32),
        classification=cls.astype(np.float32),
        rotation=rng.normal(size=(b, n, 3)).astype(np.float32),
        translation_raw=np.concatenate([rng.normal(size=(b, n, 2)), rng.uniform(0.2, 2.0, size=(b, n, 1))],
                                       axis=-1).astype(np.float32),
        hand=rng.normal(size=(b, n, 63)).astype(np.float32),
    )
    cams = np.stack([np.array([572.4, 573.6, 128.0, 128.0, 1000.0, 0.5 + 0.25 * i], np.float32)
                     for i in range(b)])
    return anc, tanc, heads, cams


@pytest.mark.parametrize("classes,tied,max_det", [(1, False, 16), (1, True, 100), (3, False, 8),
                                                  (3, True, 100), (1, True, 1)])
def test_filter_detections_fused_batch_matches_jax(classes, tied, max_det):
    rng = np.random.default_rng(classes * 100 + tied * 10 + max_det)
    anc, tanc, heads, cams = _raw_heads(rng, 3, 300, classes, tied)
    kw = dict(score_threshold=0.3, iou_threshold=0.5, max_detections=max_det)
    order = ("regression", "classification", "rotation", "translation_raw", "hand")
    want = jax.jit(lambda *a: jax_filter(*a, 256, 256, **kw))(
        *(jnp.asarray(heads[k]) for k in order), jnp.asarray(anc), jnp.asarray(tanc), jnp.asarray(cams))
    got = nms.filter_detections_fused_batch(*(T(heads[k]) for k in order), T(anc), T(tanc), T(cams),
                                            256, 256, **kw)
    assert int(np.asarray(want.num_valid).min()) > 0
    for name in ("scores", "labels", "num_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    for name in ("boxes", "rotation", "translation", "hand"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-4, err_msg=name)


def test_greedy_nms_suppresses_only_by_kept_boxes():
    # box 1 overlaps box 0 and is suppressed; box 2 overlaps only box 1, so it stays
    boxes = torch.tensor([[[0.0, 0, 10, 10], [0, 4, 10, 14], [0, 8.5, 10, 18.5]]])
    keep = nms.greedy_nms_mask(boxes, torch.ones(1, 3, dtype=torch.bool), 0.4)
    assert keep.tolist() == [[True, False, True]]


def test_top_k_breaks_ties_by_lower_index():
    scores = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1]])
    values, indices = nms.top_k(scores, 4)
    assert indices.tolist() == [[1, 3, 0, 2]]
    assert torch.equal(values, scores[:, [1, 3, 0, 2]])


# 480 -> 256, 640 -> 256 and 960 -> 256 put every half-pixel source coordinate
# on a multiple of 1/16, so the interpolation sums are exact in float32 and the
# two implementations agree to the last bit whatever their summation order
@pytest.mark.parametrize("h,w", [(480, 480), (480, 640), (960, 720), (256, 256)])
def test_preprocess_matches_jax(h, w):
    frames = np.random.default_rng(h + w).integers(0, 256, size=(2, h, w, 3), dtype=np.uint8)
    want = np.asarray(jax.jit(lambda f: jax_preprocess(f, 256))(jnp.asarray(frames)))
    got = preprocess_uint8_batch(T(frames), 256).numpy()
    assert got.shape == want.shape == (2, 256, 256, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_preprocess_other_scales_differ_by_at_most_one_level():
    # 300 -> 256 has inexact weights: the float32 sum order may move a value
    # across a .5 rounding boundary, one uint8 level (1/255/std) on a few pixels
    frames = np.random.default_rng(5).integers(0, 256, size=(2, 300, 200, 3), dtype=np.uint8)
    want = np.asarray(jax.jit(lambda f: jax_preprocess(f, 256))(jnp.asarray(frames)))
    got = preprocess_uint8_batch(T(frames), 256).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 1.0 / 255.0 / 0.224 + 1e-5
    assert np.mean(diff > 1e-5) < 1e-4
