"""Four-panel sample figure of the ground truth against the prediction.

Counterpart of ``hmd_ego_pose_tpu/utils/samplevis.py``, which draws a 10x10
inch matplotlib figure at 80 dpi (800x800 px) of one evaluated frame:
(1) the hand joints projected over the image, (2) the object's model points
projected over the image, (3) a top view (x/z) and (4) a side view (y/z) of
both in 3-D; ground truth in blue, the prediction in red.

The card's machine has no matplotlib, so this module draws the same four
panels, with the same data, colours and file name, into an 800x800 RGB
array with the rasterizer of ``utils/visualization.py`` and writes it with
``data/image.py::write_png``.  It is not matplotlib's image: there are no
titles, legend, ticks or alpha blending, markers are opaque discs and
crosses stamped on the pixel under each point, and each panel's plot box
is a fixed square (``panel_boxes``).
``panel_data`` returns what each panel plots, the numbers the JAX figure
scatters.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np

from hmd_ego_pose_tpu_torch.data.image import write_png
from hmd_ego_pose_tpu_torch.utils.visualization import draw_filled_ellipse, draw_line, draw_rectangle

FIGURE_PX = 800
GT_RGB = (31, 119, 180)  # matplotlib's "tab:blue"
PRED_RGB = (214, 39, 40)  # matplotlib's "tab:red"
FRAME_RGB = (160, 160, 160)
_MARGIN = 20  # between a panel's edge and its plot box
# marker radii in pixels for matplotlib's sizes s=12 / s=2 (discs) and s=14 ("x")
_HAND_DISC, _POINT_DISC, _CROSS = 2, 1, 3


def project(points: np.ndarray, camera_matrix: np.ndarray) -> np.ndarray:
    """(N, 3) camera-frame points -> (N, 2) pixels, z clipped at 1e-6."""
    z = np.clip(points[:, 2], 1e-6, None)
    u = camera_matrix[0, 0] * points[:, 0] / z + camera_matrix[0, 2]
    v = camera_matrix[1, 1] * points[:, 1] / z + camera_matrix[1, 2]
    return np.stack([u, v], axis=1)


def panel_data(
    camera_matrix: np.ndarray,
    gt_hand: Optional[np.ndarray] = None,
    pred_hand: Optional[np.ndarray] = None,
    gt_points: Optional[np.ndarray] = None,
    pred_points: Optional[np.ndarray] = None,
) -> List[List[Tuple[np.ndarray, Tuple[int, int, int], str]]]:
    """Per panel, in the JAX figure's scatter order: (xy (N, 2), colour, marker)
    with marker "hand" (disc), "point" (small disc) or "cross"."""
    hands = [(h, c) for h, c in ((gt_hand, GT_RGB), (pred_hand, PRED_RGB)) if h is not None]
    points = [(p, c) for p, c in ((gt_points, GT_RGB), (pred_points, PRED_RGB)) if p is not None]
    panels = [
        [(project(np.reshape(h, (21, 3)), camera_matrix), c, "hand") for h, c in hands],
        [(project(np.asarray(p), camera_matrix), c, "point") for p, c in points],
    ]
    for i, j in ((0, 2), (1, 2)):  # top view (x/z), side view (y/z)
        panel = [(np.stack([np.asarray(p)[:, i], np.asarray(p)[:, j]], axis=1), c, "point") for p, c in points]
        panel += [(np.stack([np.reshape(h, (21, 3))[:, i], np.reshape(h, (21, 3))[:, j]], axis=1), c, "cross")
                  for h, c in hands]
        panels.append(panel)
    return panels


def panel_boxes() -> List[Tuple[int, int, int]]:
    """(left, top, side) of each panel's square plot box, row by row."""
    half = FIGURE_PX // 2
    side = half - 2 * _MARGIN
    return [(col * half + _MARGIN, row * half + _MARGIN, side) for row in (0, 1) for col in (0, 1)]


def _image_transform(image_hw: Tuple[int, int], box: Tuple[int, int, int]):
    """Scale and offsets that fit the image, aspect kept, centred in the box
    (pixel centres at integer coordinates, as ``imshow`` places them)."""
    (h, w), (left, top, side) = image_hw, box
    scale = side / max(h, w)
    return scale, left + (side - w * scale) / 2, top + (side - h * scale) / 2


def _data_transform(series: List[np.ndarray], box: Tuple[int, int, int]):
    """Equal-aspect limits around the data (5 % margin), y up."""
    left, top, side = box
    xy = np.concatenate([s for s in series if len(s)], axis=0)
    xy = xy[np.all(np.isfinite(xy), axis=1)]
    if len(xy) == 0:
        return None
    lo, hi = xy.min(axis=0), xy.max(axis=0)
    span = max(float(np.max(hi - lo)) * 1.1, 1e-9)
    centre = (lo + hi) / 2
    scale = side / span
    return scale, left + side / 2 - centre[0] * scale, top + side / 2 + centre[1] * scale


@functools.lru_cache(maxsize=None)
def _stencil(kind: str) -> np.ndarray:
    """(M, 2) pixel offsets (dy, dx) of a marker about its centre pixel: a
    filled disc, or an "x" of two 2-px lines, as ``utils/visualization.py`` draws them."""
    r = {"hand": _HAND_DISC, "point": _POINT_DISC, "cross": _CROSS}[kind]
    pad = r + 2
    canvas = np.zeros((2 * pad + 1, 2 * pad + 1, 3), np.uint8)
    if kind == "cross":
        draw_line(canvas, [(pad - r, pad - r), (pad + r, pad + r)], (1, 1, 1), 2)
        draw_line(canvas, [(pad - r, pad + r), (pad + r, pad - r)], (1, 1, 1), 2)
    else:
        draw_filled_ellipse(canvas, [pad - r, pad - r, pad + r, pad + r], (1, 1, 1))
    return np.argwhere(canvas[..., 0] > 0) - pad


def _stamp(canvas: np.ndarray, xs: np.ndarray, ys: np.ndarray, colour, kind: str) -> None:
    """Every marker of one series at once, centred on the pixels under (xs, ys), clipped to ``canvas``."""
    ok = np.isfinite(xs) & np.isfinite(ys) & (np.abs(xs) < 1e6) & (np.abs(ys) < 1e6)
    centres = np.stack([np.floor(ys[ok]), np.floor(xs[ok])], axis=1).astype(np.int64)
    px = (centres[:, None, :] + _stencil(kind)[None]).reshape(-1, 2)
    h, w = canvas.shape[:2]
    px = px[(px[:, 0] >= 0) & (px[:, 0] < h) & (px[:, 1] >= 0) & (px[:, 1] < w)]
    canvas[px[:, 0], px[:, 1]] = colour


def draw_samplevis(
    image: np.ndarray,
    camera_matrix: np.ndarray,
    gt_hand: Optional[np.ndarray] = None,
    pred_hand: Optional[np.ndarray] = None,
    gt_points: Optional[np.ndarray] = None,
    pred_points: Optional[np.ndarray] = None,
    save_path: Optional[str] = None,
) -> np.ndarray:
    """The four panels as an (800, 800, 3) uint8 image, written to ``save_path`` as PNG if given.

    Args:
        image: (H, W, 3) uint8 RGB.
        gt_hand / pred_hand: (21, 3) camera-frame joints.
        gt_points / pred_points: (P, 3) camera-frame transformed model points.
    """
    canvas = np.full((FIGURE_PX, FIGURE_PX, 3), 255, np.uint8)
    boxes = panel_boxes()
    image = np.asarray(image, np.uint8)
    for p, (panel, box) in enumerate(zip(panel_data(camera_matrix, gt_hand, pred_hand, gt_points,
                                                    pred_points), boxes)):
        left, top, side = box
        if p < 2:  # over the image, nearest neighbour
            scale, x0, y0 = _image_transform(image.shape[:2], box)
            rows = np.arange(top, top + side)
            cols = np.arange(left, left + side)
            src_r = np.floor((rows + 0.5 - y0) / scale).astype(np.int64)
            src_c = np.floor((cols + 0.5 - x0) / scale).astype(np.int64)
            ok_r = (src_r >= 0) & (src_r < image.shape[0])
            ok_c = (src_c >= 0) & (src_c < image.shape[1])
            canvas[np.ix_(rows[ok_r], cols[ok_c])] = image[np.ix_(src_r[ok_r], src_c[ok_c])]

            def to_px(xy, scale=scale, x0=x0, y0=y0):
                return (xy[:, 0] + 0.5) * scale + x0, (xy[:, 1] + 0.5) * scale + y0
        else:
            fit = _data_transform([xy for xy, _, _ in panel], box)
            draw_rectangle(canvas, [left - 1, top - 1, left + side, top + side], FRAME_RGB, 1)
            if fit is None:
                continue

            def to_px(xy, fit=fit):
                scale, ox, oy = fit
                return xy[:, 0] * scale + ox, oy - xy[:, 1] * scale
        clip = canvas[top:top + side, left:left + side]  # markers stay inside the plot box
        for xy, colour, kind in panel:
            xs, ys = to_px(np.asarray(xy, np.float64))
            _stamp(clip, xs - left, ys - top, colour, kind)
    if save_path is not None:
        write_png(save_path, canvas)
    return canvas
