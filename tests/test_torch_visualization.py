"""The port's overlays and sample figures against the JAX package's (PIL and matplotlib).

* ``render_frame`` of ``utils/visualization.py`` on seeded frames, poses,
  boxes and hands (cuboids partly off the frame, joints behind the camera
  included): pixel-equal to the JAX package's, which draws with PIL.
* The three primitives at coordinates PIL meets only with broken inputs
  (NaN, beyond C's int range): equal to PIL's, errors included.
* ``draw_samplevis``: every panel's data equal to what the JAX figure
  scatters (within 1e-9 px), an 800x800x3 uint8 image written as PNG, each
  panel holding both colours where both inputs are given.
* ``cli debug`` of the port and of the JAX package on the same set: the same
  file names, every overlay pixel-equal.
"""

import os

import numpy as np
import pytest
from PIL import Image, ImageDraw

from hmd_ego_pose_tpu import cli as jax_cli
from hmd_ego_pose_tpu.utils import samplevis as jax_samplevis
from hmd_ego_pose_tpu.utils import visualization as jax_visualization
from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.data.image import read_png
from hmd_ego_pose_tpu_torch.utils import samplevis, visualization

INFO = {"min_x": -40.0, "min_y": -30.0, "min_z": -60.0, "size_x": 80.0, "size_y": 60.0, "size_z": 120.0}


def random_overlay(rng):
    """A seeded frame and everything render_frame draws over it."""
    h, w = int(rng.choice([64, 128, 256])), int(rng.choice([64, 100, 200]))
    image = rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8)
    cam = np.array([[rng.uniform(80, 300), 0, w / 2], [0, rng.uniform(80, 300), h / 2], [0, 0, 1]])
    tz = rng.uniform(50, 800) if rng.uniform() < 0.85 else rng.uniform(-50, 60)
    gt = (rng.normal(size=3), np.array([rng.normal(scale=60), rng.normal(scale=60), tz]))
    pred = (gt[0] + rng.normal(scale=0.2, size=3), gt[1] + rng.normal(scale=20, size=3))
    x, y = rng.uniform(-20, w), rng.uniform(-20, h)
    gt_box = [x, y, x + rng.uniform(0, 80), y + rng.uniform(0, 80)]
    pred_box = [v + rng.normal(scale=3) for v in gt_box]
    pred_box[2], pred_box[3] = max(pred_box[2], pred_box[0]), max(pred_box[3], pred_box[1])
    z = rng.uniform(0.05, 0.6) if rng.uniform() < 0.8 else rng.uniform(-0.1, 0.1)
    hand = rng.normal(scale=0.05, size=(21, 3)) + [0, 0, z]
    return image, cam, dict(model_info=INFO, gt_pose=gt, pred_pose=pred, gt_box=gt_box, pred_box=pred_box,
                            hand_3d=hand)


@pytest.mark.parametrize("seed", range(4))
def test_render_frame_is_pixel_equal_to_pil(seed):
    rng = np.random.RandomState(seed)
    for _ in range(40):
        image, cam, kw = random_overlay(rng)
        want = jax_visualization.render_frame(image, cam, **kw)
        got = visualization.render_frame(image, cam, **kw)
        assert got.dtype == np.uint8 and got.shape == image.shape
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, image)


def _pil(shape, draw):
    img = Image.fromarray(np.zeros(shape, np.uint8))
    try:
        draw(ImageDraw.Draw(img))
    except ValueError as e:
        return str(e)
    return np.asarray(img)


def _port(shape, draw):
    canvas = np.zeros(shape, np.uint8)
    try:
        draw(canvas)
    except ValueError as e:
        return str(e)
    return canvas


EXTREMES = [np.nan, 1e12, -1e12, 3e9, -3e9, 2147483647.5, -2147483648.7]


@pytest.mark.parametrize("primitive", ["line", "rectangle", "ellipse"])
def test_primitives_at_extreme_coordinates_equal_pil(primitive):
    """Lines with any corner extreme; rectangles with an extreme x (an extreme y
    makes PIL walk ~2**31 points); ellipses whose box stays within
    ``_MAX_ELLIPSE`` (wider ones PIL walks point by point, and the port skips)."""
    rng = np.random.RandomState(7)
    shape, ink = (40, 50, 3), (1, 2, 3)
    checked = 0
    for c in EXTREMES * 12:
        if primitive == "line":
            p = [[rng.uniform(-10, 60), rng.uniform(-10, 50)] for _ in range(2)]
            p[rng.randint(2)][rng.randint(2)] = c
            want = _pil(shape, lambda d: d.line([tuple(q) for q in p], fill=ink, width=2))
            got = _port(shape, lambda a: visualization.draw_line(a, [tuple(q) for q in p], ink, 2))
        else:
            box = [rng.uniform(-10, 30), rng.uniform(-10, 30)]
            box += [box[0] + rng.uniform(0, 30), box[1] + rng.uniform(0, 30)]
            if primitive == "rectangle":
                box[rng.choice([0, 2])] = c
                want = _pil(shape, lambda d: d.rectangle(box, outline=ink, width=2))
                got = _port(shape, lambda a: visualization.draw_rectangle(a, box, ink, 2))
            else:
                box[rng.randint(4)] = c
                x0, y0, x1, y1 = (visualization._c_int(v) for v in box)
                if max(visualization._i32(x1 - x0), visualization._i32(y1 - y0)) > visualization._MAX_ELLIPSE:
                    continue
                want = _pil(shape, lambda d: d.ellipse(box, fill=ink))
                got = _port(shape, lambda a: visualization.draw_filled_ellipse(a, box, ink))
        checked += 1
        if isinstance(want, str):
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)
    assert checked >= 40


def test_samplevis_panels_hold_the_jax_figures_data(tmp_path):
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, size=(96, 128, 3)).astype(np.uint8)
    cam = np.array([[120.0, 0, 64], [0, 120.0, 48], [0, 0, 1]])
    gt_hand = rng.normal(scale=20, size=(21, 3)) + [0, 0, 400]
    pred_hand = gt_hand + rng.normal(scale=3, size=(21, 3))
    points = rng.normal(scale=30, size=(80, 3)) + [0, 0, 400]
    fig = jax_samplevis.draw_samplevis(image, cam, gt_hand=gt_hand, pred_hand=pred_hand, gt_points=points,
                                       pred_points=points + 2.0)
    panels = samplevis.panel_data(cam, gt_hand, pred_hand, points, points + 2.0)
    assert len(panels) == len(fig.axes) == 4
    for ax, panel in zip(fig.axes, panels):
        assert len(ax.collections) == len(panel) > 0
        for collection, (xy, _, _) in zip(ax.collections, panel):
            np.testing.assert_allclose(xy, np.asarray(collection.get_offsets()), rtol=0, atol=1e-9)

    path = str(tmp_path / "samplevis_000000.png")
    out = samplevis.draw_samplevis(image, cam, gt_hand=gt_hand, pred_hand=pred_hand, gt_points=points,
                                   pred_points=points + 2.0, save_path=path)
    assert out.shape == (800, 800, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(read_png(path), out)
    for left, top, side in samplevis.panel_boxes():
        pixels = out[top:top + side, left:left + side].reshape(-1, 3)
        for colour in (samplevis.GT_RGB, samplevis.PRED_RGB):
            assert np.all(pixels == colour, axis=1).sum() > 0, (left, top, colour)


def test_samplevis_without_a_prediction_draws_one_colour():
    rng = np.random.RandomState(1)
    image = rng.randint(0, 256, size=(64, 64, 3)).astype(np.uint8)
    cam = np.array([[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]])
    out = samplevis.draw_samplevis(image, cam, gt_hand=rng.normal(scale=10, size=(21, 3)) + [0, 0, 300],
                                   gt_points=rng.normal(scale=20, size=(30, 3)) + [0, 0, 300])
    left, top, side = samplevis.panel_boxes()[3]
    pixels = out[top:top + side, left:left + side].reshape(-1, 3)
    assert np.all(pixels == samplevis.GT_RGB, axis=1).sum() > 0
    assert np.all(pixels == samplevis.PRED_RGB, axis=1).sum() == 0


@pytest.mark.parametrize("extra", [[], ["--num-objects", "2"]])
def test_cli_debug_writes_the_jax_overlays(tmp_path, extra):
    root = str(tmp_path / "syn")
    cli.main(["make-synthetic", "--out-dir", root, "--num-frames", "6", "--frame-size", "128",
              "--hand-render-version", "3", *extra])
    ids = ["--object-ids", "1,2"] if extra else []
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_cli.main(["debug", "--dataset-path", root, "--out-dir", jax_dir, "--num-images", "3", *ids])
    paths = cli.main(["debug", "--dataset-path", root, "--out-dir", port_dir, "--num-images", "3", *ids])
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir)) == sorted(os.path.basename(p) for p in paths)
    assert names == [f"debug_{i:06d}.png" for i in range(3)]
    for name in names:
        with Image.open(os.path.join(jax_dir, name)) as im:
            want = np.asarray(im)
        np.testing.assert_array_equal(read_png(os.path.join(port_dir, name)), want, err_msg=name)


def test_cli_debug_takes_no_flag_it_does_not_read(tmp_path):
    for flag in (["--device", "cpu"], ["--iter", "1"], ["--dataset", "syn_colibri"]):
        with pytest.raises(SystemExit):
            cli.main(["debug", "--dataset-path", str(tmp_path), *flag])
