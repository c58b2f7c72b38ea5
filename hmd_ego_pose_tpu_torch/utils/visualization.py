"""Detection and annotation overlays, drawn by a numpy rasterizer.

Counterpart of ``hmd_ego_pose_tpu/utils/visualization.py``: 2-D boxes,
projected 3-D cuboids (8 corners through the camera) and hand joints over a
frame, ground truth in green and the prediction in red.  ``cli debug`` and
``evaluate --save-images-path`` draw with it.

The JAX package draws with PIL's ``ImageDraw``; the card's machine has no
PIL, so this module rasterizes the three primitives it uses on an
``(H, W, 3) uint8`` array with PIL's own integer rules, pixel for pixel:

* ``rectangle(width=w)``: corners truncated toward zero as C's ``(int)``
  does, ``w`` rows and columns growing inward, the side columns drawn as
  PIL's one-pixel line draws them, leaving out the end point;
* ``line(width=w > 1)``: the quadrilateral PIL builds around the segment
  (``ImagingDrawWideLine``), filled scan line by scan line in float32 with
  PIL's rounding of each span's ends;
* ``ellipse(fill=...)``: PIL's integer ellipse walk over half-pixel
  coordinates (``ellipse_init`` / ``quarter_next``), one span a row.

Coordinates outside C's ``int`` range, and NaN, become ``INT_MIN`` and the
integer arithmetic wraps at 32 bits, as the C code does on x86-64.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from hmd_ego_pose_tpu_torch.ops.geometry import np_axis_angle_to_matrix

GT_COLOR = (0, 255, 0)
PRED_COLOR = (255, 50, 50)
HAND_COLOR = (70, 130, 255)

# the 12 edges of a cuboid whose corners are ordered by a min/max bitmask per axis
_CUBOID_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3),
    (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]
_INT_MIN = -(2 ** 31)
# PIL walks an ellipse point by point; one wider than this comes only from a
# corner within a box's width of C's int limits, and is not drawn
_MAX_ELLIPSE = 2 ** 20


def _i32(v: int) -> int:
    """C ``int`` arithmetic: wrap at 32 bits."""
    return (int(v) + 2 ** 31) % 2 ** 32 - 2 ** 31


def _c_int(v: float) -> int:
    """C's ``(int)`` cast of a double on x86-64: toward zero, ``INT_MIN`` when
    the value is NaN or out of range."""
    v = float(v)
    if not (-2147483649.0 < v < 2147483648.0):
        return _INT_MIN
    return int(math.trunc(v))


def _c_int_array(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.float64)
    ok = (v > -2147483649.0) & (v < 2147483648.0)
    return np.where(ok, np.trunc(np.where(ok, v, 0.0)), _INT_MIN).astype(np.int64)


def _round_up(f: float) -> int:
    """PIL's ``ROUND_UP`` of a double."""
    return _c_int(math.floor(f + 0.5) if f >= 0.0 else -math.floor(abs(f) + 0.5))


def _round_down(f: float) -> int:
    """PIL's ``ROUND_DOWN`` of a double."""
    return _c_int(math.ceil(f - 0.5) if f >= 0.0 else -math.ceil(abs(f) - 0.5))


def _round_up_f32(f: np.ndarray) -> np.ndarray:
    """``ROUND_UP`` of a float: ``floor(f + 0.5F)`` adds in float, ``fabs(f) + 0.5F`` in double."""
    pos = np.floor(f + np.float32(0.5)).astype(np.float64)
    neg = -np.floor(np.abs(f.astype(np.float64)) + 0.5)
    return _c_int_array(np.where(f >= 0, pos, neg))


def _round_down_f32(f: np.ndarray) -> np.ndarray:
    pos = np.ceil(f - np.float32(0.5)).astype(np.float64)
    neg = -np.ceil(np.abs(f.astype(np.float64)) - 0.5)
    return _c_int_array(np.where(f >= 0, pos, neg))


def _hline(canvas: np.ndarray, x0: int, y: int, x1: int, ink) -> None:
    """PIL's ``hline32``: x0 to x1 inclusive, clipped, nothing when x1 < x0."""
    h, w = canvas.shape[:2]
    if not 0 <= y < h:
        return
    if x0 < 0:
        x0 = 0
    elif x0 >= w:
        return
    if x1 < 0:
        return
    x1 = min(x1, w - 1)
    canvas[y, x0:x1 + 1] = ink


def _point(canvas: np.ndarray, x: int, y: int, ink) -> None:
    h, w = canvas.shape[:2]
    if 0 <= x < w and 0 <= y < h:
        canvas[y, x] = ink


def _vline(canvas: np.ndarray, x: int, y0: int, y1: int, ink) -> None:
    """PIL's one-pixel line for x0 == x1: the points y0, y0 +- 1, ... short of
    y1 (the end point left out), in 32-bit arithmetic, those on the canvas."""
    h, w = canvas.shape[:2]
    dy, ys = _i32(y1 - y0), 1
    if dy < 0:
        dy, ys = _i32(-dy), -1
    if 0 <= x < w:
        canvas[(np.arange(h) - y0) * ys % 2 ** 32 < dy, x] = ink


def _fill_polygon(canvas: np.ndarray, vertices: Sequence[Tuple[int, int]], ink) -> None:
    """PIL's scan-line polygon fill (``polygon_generic``, no alpha): the
    crossings of every row with each edge in float32, an edge's last row
    counted twice unless it is the polygon's last, spans from
    ``ROUND_UP(left)`` to ``ROUND_DOWN(right)``; horizontal edges as lines."""
    h = canvas.shape[0]
    ymin, ymax = h - 1, 0
    edges = []
    for (x0, y0), (x1, y1) in zip(vertices, list(vertices[1:]) + [vertices[0]]):
        lo, hi = min(y0, y1), max(y0, y1)
        ymin, ymax = min(ymin, lo), max(ymax, hi)
        if y0 == y1:
            _hline(canvas, min(x0, x1), y0, max(x0, x1), ink)
            continue
        dx = np.float32(np.float32(_i32(x1 - x0)) / np.float32(_i32(y1 - y0)))
        edges.append((x0, y0, lo, hi, dx))
    ymin, ymax = max(ymin, 0), min(ymax, h)
    if not edges or ymax < ymin:
        return
    rows = np.arange(ymin, ymax + 1, dtype=np.int64)
    crossings = []
    for x0, y0, lo, hi, dx in edges:
        active = (rows >= lo) & (rows <= hi)
        offset = (rows - y0 + 2 ** 31) % 2 ** 32 - 2 ** 31
        x = offset.astype(np.float32) * dx + np.float32(x0)
        crossings.append(np.where(active, x, np.nan))
        crossings.append(np.where(active & (rows == hi) & (rows < ymax), x, np.nan))
    xx = np.sort(np.stack(crossings, axis=1), axis=1)  # NaN (no crossing) sorts last
    count = np.sum(~np.isnan(xx), axis=1)
    for p in range(0, xx.shape[1] - 1, 2):
        left, right = xx[:, p], xx[:, p + 1]
        valid = p + 1 < count
        start = _round_up_f32(np.where(valid, left, 0).astype(np.float32))
        end = _round_down_f32(np.where(valid, right, 0).astype(np.float32))
        for r in np.nonzero(valid & (end >= start))[0]:
            _hline(canvas, int(start[r]), int(rows[r]), int(end[r]), ink)


def _wide_line(canvas: np.ndarray, x0: int, y0: int, x1: int, y1: int, ink, width: int) -> None:
    """PIL's ``ImagingDrawWideLine``: the segment's quadrilateral, filled."""
    dx, dy = _i32(x1 - x0), _i32(y1 - y0)
    if dx == 0 and dy == 0:
        _point(canvas, x0, y0, ink)
        return
    big = math.hypot(dx, dy)
    small = (width - 1) / 2.0
    ratio_max, ratio_min = _round_up(small) / big, _round_down(small) / big
    dxmin, dxmax = _round_down(ratio_min * dy), _round_down(ratio_max * dy)
    dymin, dymax = _round_down(ratio_min * dx), _round_down(ratio_max * dx)
    _fill_polygon(canvas, [
        (_i32(x0 - dxmin), _i32(y0 + dymax)), (_i32(x1 - dxmin), _i32(y1 + dymax)),
        (_i32(x1 + dxmax), _i32(y1 - dymin)), (_i32(x0 + dxmax), _i32(y0 - dymin)),
    ], ink)


def draw_rectangle(canvas: np.ndarray, box, ink, width: int = 1) -> None:
    """``ImageDraw.rectangle(box, outline=ink, width=width)``."""
    x0, y0, x1, y1 = (float(v) for v in box)
    if x1 < x0:
        raise ValueError("x1 must be greater than or equal to x0")
    if y1 < y0:
        raise ValueError("y1 must be greater than or equal to y0")
    x0, y0, x1, y1 = _c_int(x0), _c_int(y0), _c_int(x1), _c_int(y1)
    if y0 > y1:  # only a NaN corner gets here
        y0, y1 = y1, y0
    width = max(width, 1)
    for i in range(width):
        _hline(canvas, x0, _i32(y0 + i), x1, ink)
        _hline(canvas, x0, _i32(y1 - i), x1, ink)
        _vline(canvas, _i32(x1 - i), _i32(y0 + width), _i32(y1 - width + 1), ink)
        _vline(canvas, _i32(x0 + i), _i32(y0 + width), _i32(y1 - width + 1), ink)


def draw_line(canvas: np.ndarray, points, ink, width: int = 2) -> None:
    """``ImageDraw.line(points, fill=ink, width=width)`` for ``width`` > 1 (no joints)."""
    if width < 2:
        raise ValueError("only wide lines (width > 1) are rasterized")
    xy = [(_c_int(x), _c_int(y)) for x, y in points]
    for (x0, y0), (x1, y1) in zip(xy, xy[1:]):
        _wide_line(canvas, x0, y0, x1, y1, ink, width)


def _quarter(a: int, b: int):
    """PIL's ``quarter_next`` walk: points of a quarter ellipse in half pixels."""
    cx, cy, ex, ey = a, b % 2, a % 2, b
    a2, b2 = a * a, b * b
    a2b2 = a2 * b2

    def delta(x, y):
        return abs(a2 * y * y + b2 * x * x - a2b2)

    while True:
        yield cx, cy
        if cx == ex and cy == ey:
            return
        nx, ny = cx, cy + 2
        nd = delta(nx, ny)
        if nx > 1:
            d = delta(cx - 2, cy + 2)
            if nd > d:
                nx, ny, nd = cx - 2, cy + 2, d
            if nd > delta(cx - 2, cy):
                nx, ny = cx - 2, cy
        cx, cy = nx, ny


@functools.lru_cache(maxsize=256)
def _filled_ellipse_spans(a: int, b: int) -> Tuple[Tuple[int, int, int], ...]:
    """(x0, y, x1) spans, relative to the box's corner, of PIL's filled ellipse
    of width ``a`` and height ``b`` (``ellipse_init`` with ``w = a + b``: the
    inner quarter is empty, so every span starts at the leftmost column)."""
    if a + b < 1:
        return ()
    leftmost = a % 2
    walk = _quarter(a, b)
    pr, py = next(walk)
    spans = []
    finished = False
    while not finished:
        y, l, r = py, leftmost, pr
        for cx, cy in walk:
            if cy > y:
                pr, py = cx, cy
                break
        else:
            finished = True
        row = []
        if (l > 0 or l < r) and y > 0:
            row.append((2 if l == 0 else l, y, r))
        if y > 0:
            row.append((-r, y, -l))
        if l > 0 or l < r:
            row.append((2 if l == 0 else l, -y, r))
        row.append((-r, -y, -l))
        spans.extend(((x0 + a) // 2, (yy + b) // 2, (x1 + a) // 2) for x0, yy, x1 in reversed(row))
    return tuple(spans)


def draw_filled_ellipse(canvas: np.ndarray, box, ink) -> None:
    """``ImageDraw.ellipse(box, fill=ink)``."""
    x0, y0, x1, y1 = (float(v) for v in box)
    if x1 < x0:
        raise ValueError("x1 must be greater than or equal to x0")
    if y1 < y0:
        raise ValueError("y1 must be greater than or equal to y0")
    x0, y0, x1, y1 = _c_int(x0), _c_int(y0), _c_int(x1), _c_int(y1)
    a, b = _i32(x1 - x0), _i32(y1 - y0)
    if a < 0 or b < 0 or max(a, b) > _MAX_ELLIPSE:
        return
    for sx0, sy, sx1 in _filled_ellipse_spans(a, b):
        _hline(canvas, _i32(x0 + sx0), _i32(y0 + sy), _i32(x0 + sx1), ink)


def cuboid_corners(model_info: dict) -> np.ndarray:
    """(8, 3) cuboid corners from a models_info entry."""
    mn = np.array([model_info["min_x"], model_info["min_y"], model_info["min_z"]])
    sz = np.array([model_info["size_x"], model_info["size_y"], model_info["size_z"]])
    corners = []
    for bits in range(8):
        offset = np.array([(bits >> a) & 1 for a in range(3)]) * sz
        corners.append(mn + offset)
    return np.stack(corners)


def project(points_3d, rotation_vec, translation, camera_matrix) -> np.ndarray:
    r = np_axis_angle_to_matrix(np.asarray(rotation_vec))
    cam = points_3d @ r.T + np.asarray(translation)
    z = np.clip(cam[:, 2], 1e-6, None)
    u = camera_matrix[0, 0] * cam[:, 0] / z + camera_matrix[0, 2]
    v = camera_matrix[1, 1] * cam[:, 1] / z + camera_matrix[1, 2]
    return np.stack([u, v], axis=1)


def draw_box_2d(canvas: np.ndarray, box, color, width: int = 2) -> None:
    draw_rectangle(canvas, box, color, width)


def draw_cuboid(canvas: np.ndarray, corners_2d, color, width: int = 2) -> None:
    for a, b in _CUBOID_EDGES:
        draw_line(canvas, [tuple(corners_2d[a]), tuple(corners_2d[b])], color, width)


def draw_hand(canvas: np.ndarray, joints_2d, color=HAND_COLOR, radius: int = 3) -> None:
    for u, v in joints_2d:
        draw_filled_ellipse(canvas, [u - radius, v - radius, u + radius, v + radius], color)


def render_frame(
    image: np.ndarray,
    camera_matrix: np.ndarray,
    model_info: Optional[dict] = None,
    gt_pose: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    pred_pose: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    gt_box: Optional[Sequence[float]] = None,
    pred_box: Optional[Sequence[float]] = None,
    hand_3d: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The overlay over a copy of ``image``; returns an RGB uint8 image."""
    canvas = np.array(image.astype(np.uint8))
    if gt_box is not None:
        draw_box_2d(canvas, gt_box, GT_COLOR)
    if pred_box is not None:
        draw_box_2d(canvas, pred_box, PRED_COLOR)
    if model_info is not None:
        corners = cuboid_corners(model_info)
        if gt_pose is not None:
            draw_cuboid(canvas, project(corners, *gt_pose, camera_matrix), GT_COLOR)
        if pred_pose is not None:
            draw_cuboid(canvas, project(corners, *pred_pose, camera_matrix), PRED_COLOR)
    if hand_3d is not None:
        joints = np.asarray(hand_3d).reshape(21, 3)
        z = np.clip(joints[:, 2], 1e-6, None)
        u = camera_matrix[0, 0] * joints[:, 0] / z + camera_matrix[0, 2]
        v = camera_matrix[1, 1] * joints[:, 1] / z + camera_matrix[1, 2]
        draw_hand(canvas, np.stack([u, v], axis=1))
    return canvas
