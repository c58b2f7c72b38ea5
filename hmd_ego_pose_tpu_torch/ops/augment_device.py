"""Training augmentation on the device: colour RandAugment and the 6-DoF warp, batched.

Counterpart of ``hmd_ego_pose_tpu/ops/augment_device.py``: the same 14
colour ops with the same formulas and uint8 truncation points, the same
inverse-affine warp (``jax.scipy.ndimage.map_coordinates`` order 1 for the
frame, order 0 for the mask, zero border), the same label updates, and the
same fall back to the unaugmented sample when the object's mask leaves the
frame.

Randomness.  The JAX package draws inside the ops from ``jax.random``
keys, which torch cannot reproduce.  Here every op takes its drawn values
as arguments (``AugmentDraws``), and ``draw_augment`` draws them all from
one explicit ``torch.Generator`` with the JAX package's distributions:
whether to augment (uniform >= ``chance_no_augmentation``), how many colour
slots (1 or 2), each slot's op (0..13) and magnitude (1..13), a uniform
factor per slot, a cutout centre per slot, standard normal noise for the
slots that drew the noise op, and the warp's angle (0..360 degrees) and
scale.  The trainer passes a host (CPU) generator, so grouping by op needs
no read from the device; the tests build the draws from a JAX key and hold
the port to the JAX function.

Per-example branches.  The JAX package switches among the 14 ops per
example and slot (``lax.switch`` under ``vmap``, which becomes a select over
every branch).  A Python loop over the examples would make hundreds of
launches per step.  Two versions here, equal row for row:

* ``color_augment_batch`` (eager): each slot groups the batch by op on the
  host and runs every op once on its group (at most 13 op calls per slot),
  writing the group back by index, so each row goes through one op per
  slot.  The eager step, the windowed and host-pipeline paths, the
  data-parallel ranks and remat run it: it is the faster of the two
  whenever the kernels may change from step to step, on the CPU and on
  the card (``scripts/colour_pass_times.py``, PERF.md);
* ``color_augment_fixed`` (fixed shapes, JAX's select): each slot runs all
  13 ops over the whole batch and each row takes its op's result, from the
  draws in fixed-shape tensors (``SlotDraws``, written by
  ``write_slot_draws``), so the same kernels run every step: the resident
  step's CUDA graph, whose replay cannot choose kernels, runs it
  (``train/step.py::ResidentGraph``).

The contrast op's mean grey level is summed in integers (``_mean_level``), so
a row's mean does not depend on how many rows its reduction sees.

Objects.  A frame holds K objects (K = 1 in the colibri sets, mask value
255); a multi-object scene's mask holds each object at its own pixel value
(``RawBatch.gt_mask_values``).  The warp is shared by the objects of a
frame; each object's labels and its bbox, from the warped mask at its value,
are its own.  An object whose mask leaves the frame keeps its row with
``valid`` cleared, and the frame falls back to its input only when every
valid object left (``augment_6dof_device_multi`` of the JAX package).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from hmd_ego_pose_tpu_torch.ops.geometry import axis_angle_to_matrix
from hmd_ego_pose_tpu_torch.ops.preprocess import preprocess_uint8_batch

_EPS = 1e-12
NUM_OPS = 14
MAX_SLOTS = 2  # 1 or 2 active colour slots per example
IDENTITY = NUM_OPS - 1
(AUTOCONTRAST, EQUALIZE, INVERT, POSTERIZE, SOLARIZE, COLOR, CONTRAST, BRIGHTNESS,
 SHARPNESS, CUTOUT, GAUSSIAN_NOISE, BLUR, SMOOTH) = range(13)


# ---------------------------------------------------------------------------
# Rotation matrix -> compact axis-angle (branchless)
# ---------------------------------------------------------------------------


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector: quaternion by
    Shepperd's method (4-way select), robust at angle ~ 0 and ~ pi."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    t0 = 1.0 + m00 + m11 + m22
    t1 = 1.0 + m00 - m11 - m22
    t2 = 1.0 - m00 + m11 - m22
    t3 = 1.0 - m00 - m11 + m22

    def root(t):
        return torch.sqrt(torch.clamp(t, min=_EPS)) * 2.0

    s0, s1, s2, s3 = root(t0), root(t1), root(t2), root(t3)
    cand0 = torch.stack([s0 / 4.0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], dim=-1)
    cand1 = torch.stack([(m21 - m12) / s1, s1 / 4.0, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1)
    cand2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, s2 / 4.0, (m12 + m21) / s2], dim=-1)
    cand3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, s3 / 4.0], dim=-1)
    best = torch.argmax(torch.stack([t0, t1, t2, t3], dim=-1), dim=-1)[..., None]
    q = torch.where(best == 0, cand0, torch.where(best == 1, cand1, torch.where(best == 2, cand2, cand3)))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    q = torch.where(q[..., 0:1] < 0, -q, q)  # w >= 0: angle in [0, pi]
    w, v = q[..., 0], q[..., 1:]
    n = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * torch.atan2(n, w)
    big = n > 1e-9
    scale = torch.where(big, angle / torch.where(big, n, torch.ones_like(n)), torch.full_like(n, 2.0))
    return v * scale[..., None]


# ---------------------------------------------------------------------------
# Affine warp (inverse map, zero border)
# ---------------------------------------------------------------------------


def inverse_affine(angle_deg: torch.Tensor, scale: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor
                   ) -> torch.Tensor:
    """(B,) angles, scales and centres -> (B, 2, 3) inverse of
    cv2.getRotationMatrix2D(centre, angle, scale)."""
    a = angle_deg * (math.pi / 180.0)
    alpha = scale * torch.cos(a)
    beta = scale * torch.sin(a)
    tx = (1.0 - alpha) * cx - beta * cy
    ty = beta * cx + (1.0 - alpha) * cy
    det = alpha * alpha + beta * beta
    ia, ib = alpha / det, beta / det
    itx = -(ia * tx + (-ib) * ty)
    ity = -(ib * tx + ia * ty)
    return torch.stack([torch.stack([ia, -ib, itx], dim=-1), torch.stack([ib, ia, ity], dim=-1)], dim=-2)


def _src_coords(inv: torch.Tensor, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 2, 3) -> source (y, x) of every output pixel, (B, H, W) each."""
    ys = torch.arange(h, device=inv.device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=inv.device, dtype=torch.float32)[None, None, :]
    c = inv[:, :, :, None, None]
    src_x = c[:, 0, 0] * xs + c[:, 0, 1] * ys + c[:, 0, 2]
    src_y = c[:, 1, 0] * xs + c[:, 1, 1] * ys + c[:, 1, 2]
    return src_y, src_x


def _taps(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C) at integer (B, H', W') taps, 0 outside the image -> (B, H', W', C)."""
    b, h, w, c = img.shape
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    flat = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(b, -1, 1).expand(-1, -1, c)
    vals = torch.gather(img.reshape(b, h * w, c), 1, flat).reshape(b, *iy.shape[1:], c)
    return torch.where(valid[..., None], vals, torch.zeros_like(vals))


def warp_bilinear_u8(images: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> warped uint8: map_coordinates order 1, taps summed
    (y0 x0) + (y0 x1) + (y1 x0) + (y1 x1), rounded half to even."""
    _, h, w, _ = images.shape
    src_y, src_x = _src_coords(inv, h, w)
    img = images.to(torch.float32)
    ly, lx = torch.floor(src_y), torch.floor(src_x)
    wy1, wx1 = src_y - ly, src_x - lx
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy, ix = ly.to(torch.int64), lx.to(torch.int64)
    out = None
    for dy, wy in ((0, wy0), (1, wy1)):
        for dx, wx in ((0, wx0), (1, wx1)):
            term = (wy * wx)[..., None] * _taps(img, iy + dy, ix + dx)
            out = term if out is None else out + term
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    t = torch.trunc(x)
    return t + torch.where(torch.abs(x - t) >= 0.5, torch.sign(x), torch.zeros_like(x))


def warp_nearest_u8(masks: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 mask -> warped mask: map_coordinates order 0 (indices
    rounded half away from zero), zero border."""
    _, h, w = masks.shape
    src_y, src_x = _src_coords(inv, h, w)
    iy, ix = _round_half_away(src_y).to(torch.int64), _round_half_away(src_x).to(torch.int64)
    return _taps(masks[..., None], iy, ix)[..., 0]


def bbox_from_mask(sel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) bool -> ((B, 4) [x1, y1, x2, y2] float32 inclusive extrema, (B,) any)."""
    _, h, w = sel.shape
    any_row, any_col = sel.any(dim=2), sel.any(dim=1)
    ys = torch.arange(h, device=sel.device)
    xs = torch.arange(w, device=sel.device)
    y1 = torch.where(any_row, ys, h).amin(dim=1)
    y2 = torch.where(any_row, ys, -1).amax(dim=1)
    x1 = torch.where(any_col, xs, w).amin(dim=1)
    x2 = torch.where(any_col, xs, -1).amax(dim=1)
    valid = any_row.any(dim=1)
    bbox = torch.stack([x1, y1, x2, y2], dim=-1).to(torch.float32)
    return torch.where(valid[:, None], bbox, torch.zeros_like(bbox)), valid


# ---------------------------------------------------------------------------
# Colour ops on (M, H, W, 3) float32 images holding uint8 values
# ---------------------------------------------------------------------------
# Each takes its group's magnitudes m (M,) float32 and its drawn values.


def _u8(x):
    return torch.floor(torch.clamp(x, 0.0, 255.0))


def _grayscale(img):
    return torch.floor(0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])


def _blend(a, b, factor):
    return _u8(a + (b - a) * factor[:, None, None, None])


def _factor(m, r):
    return 0.1 + m * 1.8 / 14.0 * r


def op_autocontrast(img, m):
    lo = torch.floor(torch.amin(img, dim=(1, 2), keepdim=True))
    hi = torch.floor(torch.amax(img, dim=(1, 2), keepdim=True))
    span = torch.clamp(hi - lo, min=1.0)
    # 255 / span divided, as JAX does (a number over a tensor is reciprocal() * 255 in torch)
    stretched = torch.floor((img - lo) * (torch.full_like(span, 255.0) / span))
    return torch.where(hi <= lo, img, torch.clamp(stretched, 0, 255))


def op_equalize(img, m):
    mm, h, w, c = img.shape
    flat = img.to(torch.int64).permute(0, 3, 1, 2).reshape(mm, c, h * w)
    hist = torch.zeros((mm, c, 256), dtype=torch.int64, device=img.device)
    hist.scatter_add_(2, flat, torch.ones_like(flat))  # integer adds: exact in any order
    cdf = torch.cumsum(hist, dim=2)
    last = cdf[..., -1:]
    cdf_min = torch.where(hist > 0, cdf, last + 1).amin(dim=2, keepdim=True)
    denom = last - cdf_min
    lut = torch.clamp(torch.round((cdf - cdf_min).to(torch.float32) * 255.0
                                  / torch.clamp(denom, min=1).to(torch.float32)), 0, 255)
    out = torch.gather(lut, 2, flat).reshape(mm, c, h, w).permute(0, 2, 3, 1)
    return torch.where((denom == 0)[:, None, :, :].reshape(mm, 1, 1, c), img, out)


def op_invert(img, m):
    return 255.0 - img


def op_posterize(img, m):
    bits = torch.clamp(8 - torch.floor(m * 4.0 / 14.0).to(torch.int32), min=1)
    q = torch.exp2((8 - bits).to(torch.float32))[:, None, None, None]
    return torch.floor(img / q) * q


def op_solarize(img, m):
    threshold = (256.0 - torch.floor(m * 256.0 / 14.0))[:, None, None, None]
    return torch.where(img < threshold, img, 255.0 - img)


def op_color(img, m, r):
    gray = _grayscale(img)[..., None] * torch.ones(3, device=img.device)
    return _blend(gray, img, _factor(m, r))


def _mean_level(gray):
    """(M, H, W) integer grey levels -> (M,) float32 mean per row: the levels
    summed exactly in int64, then divided in float32 (a float32 sum is exact
    only up to 2**24 / 255 pixels, and its rounding would then depend on how
    the reduction splits the rows); the divisor a tensor, so the card divides
    as the CPU does instead of multiplying by a reciprocal."""
    total = gray.to(torch.int64).sum(dim=(1, 2)).to(torch.float32)
    return total / torch.full_like(total, float(gray.shape[1] * gray.shape[2]))


def op_contrast(img, m, r):
    mean = torch.floor(_mean_level(_grayscale(img)))
    return _blend(mean[:, None, None, None].expand_as(img), img, _factor(m, r))


def op_brightness(img, m, r):
    return _blend(torch.zeros_like(img), img, _factor(m, r))


def _conv3x3(img, kernel):
    """Edge-padded 3x3 filter as 9 shifted adds, in row-major tap order."""
    _, h, w, _ = img.shape
    pad = torch.nn.functional.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)
    out = torch.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            out = out + kernel[dy][dx] * pad[:, dy:dy + h, dx:dx + w, :]
    return _u8(out)


_SMOOTH_K = [[1 / 13.0] * 3, [1 / 13.0, 5 / 13.0, 1 / 13.0], [1 / 13.0] * 3]
_BLUR_K = [[1 / 9.0] * 3] * 3


def op_sharpness(img, m, r):
    return _blend(_conv3x3(img, _SMOOTH_K), img, _factor(m, r))


def op_cutout(img, m, yx):
    """``yx``: (M, 2) integer centres, drawn uniformly in [0, H) x [0, W)."""
    _, h, w, _ = img.shape
    size = torch.floor(min(h, w) * (0.1 + 0.3 * m / 14.0)).to(torch.int64)[:, None, None]
    y, x = yx[:, 0, None, None], yx[:, 1, None, None]
    half = torch.div(size, 2, rounding_mode="floor")
    ys = torch.arange(h, device=img.device)[None, :, None]
    xs = torch.arange(w, device=img.device)[None, None, :]
    box = ((ys >= torch.clamp(y - half, min=0)) & (ys < y + half)
           & (xs >= torch.clamp(x - half, min=0)) & (xs < x + half))
    out = torch.where(box[..., None], torch.full_like(img, 127.0), img)
    return torch.where((size == 0)[..., None], img, out)


def op_gaussian_noise(img, m, noise):
    """``noise``: (M, H, W, 3) standard normal draws."""
    sigma = (m / 14.0 * 25.0)[:, None, None, None]
    return _u8(img + noise * sigma)


def op_blur(img, m):
    return _conv3x3(img, _BLUR_K)


def op_smooth(img, m):
    return _conv3x3(img, _SMOOTH_K)


_FACTOR_OPS = {COLOR: op_color, CONTRAST: op_contrast, BRIGHTNESS: op_brightness, SHARPNESS: op_sharpness}
_PLAIN_OPS = {AUTOCONTRAST: op_autocontrast, EQUALIZE: op_equalize, INVERT: op_invert, POSTERIZE: op_posterize,
              SOLARIZE: op_solarize, BLUR: op_blur, SMOOTH: op_smooth}


def apply_op(op: int, img, m, r=None, yx=None, noise=None):
    """Colour op ``op`` (not the identity) on the rows ``img``, with their
    magnitudes ``m`` (M,) and, where the op takes them, factors ``r`` (M,),
    cutout centres ``yx`` (M, 2) or noise (M, H, W, 3)."""
    if op in _FACTOR_OPS:
        return _FACTOR_OPS[op](img, m, r)
    if op == CUTOUT:
        return op_cutout(img, m, yx)
    if op == GAUSSIAN_NOISE:
        return op_gaussian_noise(img, m, noise)
    return _PLAIN_OPS[op](img, m)


# ---------------------------------------------------------------------------
# The draws, and the batch
# ---------------------------------------------------------------------------


class AugmentDraws(NamedTuple):
    """Every random value of one batch's augmentation (host or device tensors)."""

    apply: torch.Tensor  # (B,) bool: augment this example at all
    n_slots: torch.Tensor  # (B,) int64 in [1, 3): active colour slots
    op_ids: torch.Tensor  # (B, 2) int64 in [0, 14)
    magnitudes: torch.Tensor  # (B, 2) int64 in [1, 14)
    factors: torch.Tensor  # (B, 2) float32 uniform: colour/contrast/brightness/sharpness
    cutout_yx: torch.Tensor  # (B, 2, 2) int64 cutout centres per slot
    noise: Dict[int, torch.Tensor]  # slot -> (M, H, W, 3) standard normals, one per
    # example whose active op in that slot is the noise op, in example order
    angles: torch.Tensor  # (B,) float32 degrees in [0, 360)
    scales: torch.Tensor  # (B,) float32 in scale_range


def slot_ops(draws: AugmentDraws, slot: int) -> List[int]:
    """The op each example runs in ``slot`` (identity where inactive or not augmented)."""
    active = (draws.apply & (slot < draws.n_slots)).tolist()
    return [op if on else IDENTITY for op, on in zip(draws.op_ids[:, slot].tolist(), active)]


def draw_augment(generator: torch.Generator, batch: int, height: int, width: int,
                 chance_no_augmentation: float = 0.02,
                 scale_range: Tuple[float, float] = (0.7, 1.3)) -> AugmentDraws:
    """All of one batch's draws from ``generator`` (on its device), with the
    JAX package's distributions."""
    g, dev = generator, generator.device
    apply = torch.rand(batch, generator=g, device=dev) >= chance_no_augmentation
    n_slots = torch.randint(1, 3, (batch,), generator=g, device=dev)
    op_ids = torch.randint(0, NUM_OPS, (batch, MAX_SLOTS), generator=g, device=dev)
    magnitudes = torch.randint(1, 14, (batch, MAX_SLOTS), generator=g, device=dev)
    factors = torch.rand((batch, MAX_SLOTS), generator=g, device=dev)
    cut_y = torch.randint(0, height, (batch, MAX_SLOTS), generator=g, device=dev)
    cut_x = torch.randint(0, width, (batch, MAX_SLOTS), generator=g, device=dev)
    angles = torch.rand(batch, generator=g, device=dev) * 360.0
    scales = torch.rand(batch, generator=g, device=dev) * (scale_range[1] - scale_range[0]) + scale_range[0]
    draws = AugmentDraws(apply, n_slots, op_ids, magnitudes, factors,
                         torch.stack([cut_y, cut_x], dim=-1), {}, angles, scales)
    for slot in range(MAX_SLOTS):
        m = sum(op == GAUSSIAN_NOISE for op in slot_ops(draws, slot))
        if m:
            draws.noise[slot] = torch.randn((m, height, width, 3), generator=g, device=dev)
    return draws


def take_rows(draws: AugmentDraws, rows: slice) -> AugmentDraws:
    """The draws of the examples ``rows`` (contiguous) of a batch's draws: a
    data-parallel rank draws for the global batch, as one process would, and
    keeps its rows; each slot's noise keeps the draws of its rows' noise
    examples, in order."""
    b = draws.apply.shape[0]
    picked = range(b)[rows]
    noise = {}
    for slot, values in draws.noise.items():
        order = [e for e, op in enumerate(slot_ops(draws, slot)) if op == GAUSSIAN_NOISE]
        mine = [i for i, e in enumerate(order) if e in picked]
        if mine:
            noise[slot] = values[mine[0]:mine[-1] + 1]
    return AugmentDraws(draws.apply[rows], draws.n_slots[rows], draws.op_ids[rows], draws.magnitudes[rows],
                        draws.factors[rows], draws.cutout_yx[rows], noise, draws.angles[rows], draws.scales[rows])


def color_augment_batch(images_u8: torch.Tensor, draws: AugmentDraws) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> colour-augmented uint8: per slot, the batch grouped
    by op and each op run once on its group."""
    img = images_u8.to(torch.float32)
    dev = img.device
    for slot in range(MAX_SLOTS):
        ops = slot_ops(draws, slot)
        for op in sorted(set(ops) - {IDENTITY}):
            rows = [b for b, o in enumerate(ops) if o == op]
            idx = torch.tensor(rows, device=dev)
            m = draws.magnitudes[rows, slot].to(device=dev, dtype=torch.float32)
            r = draws.factors[rows, slot].to(device=dev, dtype=torch.float32) if op in _FACTOR_OPS else None
            yx = draws.cutout_yx[rows, slot].to(dev) if op == CUTOUT else None
            noise = draws.noise[slot].to(dev) if op == GAUSSIAN_NOISE else None
            img = img.index_copy(0, idx, apply_op(op, img.index_select(0, idx), m, r, yx, noise))
    return img.to(torch.uint8)


class SlotDraws(NamedTuple):
    """A batch's colour draws in fixed shapes, for ``color_augment_fixed``: the
    static inputs of the resident step's CUDA graph.  ``noise`` holds each
    slot's noise draws from row 0, in example order (``AugmentDraws.noise``),
    and each example reads its own row through ``noise_rows``."""

    ops: torch.Tensor  # (2, B) int64: each slot's op per example (``slot_ops``)
    magnitudes: torch.Tensor  # (B, 2) float32
    factors: torch.Tensor  # (B, 2) float32
    cutout_yx: torch.Tensor  # (B, 2, 2) int64
    noise_rows: torch.Tensor  # (2, B) int64: the row of ``noise[slot]`` of each example (0 without noise)
    noise: torch.Tensor  # (2, N, H, W, 3) float32, N at least either slot's noise draws


def noise_rows(ops: List[int]) -> List[int]:
    """One slot's ops -> the row of the slot's noise draws each example reads
    (the draws are in example order; 0 for an example without noise)."""
    rows, n = [], 0
    for op in ops:
        rows.append(n if op == GAUSSIAN_NOISE else 0)
        n += op == GAUSSIAN_NOISE
    return rows


def write_slot_draws(draws: AugmentDraws, out: SlotDraws) -> None:
    """Write ``draws`` (host tensors) into the ``SlotDraws`` buffers ``out``
    (any device): each slot's noise draws into the first rows of
    ``out.noise[slot]``; the rows beyond them are left as they are (no
    example reads them)."""
    ops = [slot_ops(draws, slot) for slot in range(MAX_SLOTS)]
    out.ops.copy_(torch.tensor(ops))
    out.noise_rows.copy_(torch.tensor([noise_rows(o) for o in ops]))
    for name in ("magnitudes", "factors", "cutout_yx"):
        getattr(out, name).copy_(getattr(draws, name))
    for slot, values in draws.noise.items():
        out.noise[slot, :values.shape[0]].copy_(values)


def slot_draws(draws: AugmentDraws, height: int, width: int, device=None) -> SlotDraws:
    """``draws`` as new ``SlotDraws`` on ``device`` (default: the draws'), the
    noise in a (2, B, H, W, 3) tensor of zeros beyond the draws."""
    b = draws.apply.shape[0]
    dev = draws.apply.device if device is None else torch.device(device)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = SlotDraws(empty((MAX_SLOTS, b), torch.int64), empty((b, MAX_SLOTS)), empty((b, MAX_SLOTS)),
                    empty((b, MAX_SLOTS, 2), torch.int64), empty((MAX_SLOTS, b), torch.int64),
                    torch.zeros((MAX_SLOTS, b, height, width, 3), device=dev))
    write_slot_draws(draws, out)
    return out


def color_augment_fixed(images_u8: torch.Tensor, draws: SlotDraws) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> colour-augmented uint8, as ``color_augment_batch``
    row for row, in fixed shapes: per slot, every op over the whole batch and
    each row's result selected by its op id (the identity keeps the row)."""
    img = images_u8.to(torch.float32)
    for slot in range(MAX_SLOTS):
        ops, m, r, yx = draws.ops[slot], draws.magnitudes[:, slot], draws.factors[:, slot], draws.cutout_yx[:, slot]
        noise = draws.noise[slot].index_select(0, draws.noise_rows[slot])
        out = img
        for op in range(IDENTITY):
            out = torch.where((ops == op)[:, None, None, None], apply_op(op, img, m, r, yx, noise), out)
        img = out
    return img.to(torch.uint8)


class RawBatch(NamedTuple):
    """Unaugmented frames and raw labels of a batch, on the device."""

    frames: torch.Tensor  # (B, H, W, 3) uint8
    masks: torch.Tensor  # (B, H, W) uint8
    camera_fxfycxcy: torch.Tensor  # (B, 4) float32
    gt_boxes: torch.Tensor  # (B, K, 4) frame-pixel xyxy
    gt_rotations: torch.Tensor  # (B, K, 3) axis-angle radians
    gt_is_sym: torch.Tensor  # (B, K) float32
    gt_translations: torch.Tensor  # (B, K, 3) mm
    gt_coords_3d: torch.Tensor  # (B, K, 21, 3)
    gt_labels: torch.Tensor  # (B, K) int32
    gt_valid: torch.Tensor  # (B, K) bool
    gt_mask_values: Optional[torch.Tensor] = None  # (B, K) int32; None: all 255


class Augmented(NamedTuple):
    images: torch.Tensor  # (B, H, W, 3) uint8
    bboxes: torch.Tensor  # (B, K, 4)
    rotations: torch.Tensor  # (B, K, 3)
    translations: torch.Tensor  # (B, K, 3)
    coords_3d: torch.Tensor  # (B, K, 21, 3)
    valid: torch.Tensor  # (B, K) bool
    applied: torch.Tensor  # (B,) bool: the warp was kept


def augment_6dof_batch(images, masks, bboxes, rotations, translations, coords_3d, valid,
                       cx, cy, angle_deg, scale, mask_values: Optional[torch.Tensor] = None) -> Augmented:
    """Warp B frames and the labels of their K objects about the principal
    point (``augment_6dof_device_multi`` of the JAX package, batched): image
    by -angle, poses composed with a +angle camera-Z rotation, Tz and the hand
    joints' z divided by the scale, each object's bbox recomputed from the
    warped mask at its own pixel value.  An object whose mask leaves the frame
    has its ``valid`` cleared; an example keeps its input when no valid object
    is left.  ``mask_values``: (B, K) each object's mask pixel value (None:
    255, one object per frame)."""
    b, k = bboxes.shape[:2]
    if mask_values is None:
        if k != 1:
            raise ValueError("K > 1 objects need per-object mask values (RawBatch.gt_mask_values)")
        mask_values = torch.full((b, k), 255, dtype=torch.int32, device=masks.device)
    inv = inverse_affine(-angle_deg, scale, cx, cy)
    aug_image = warp_bilinear_u8(images, inv)
    aug_mask = warp_nearest_u8(masks, inv)
    obj_mask = aug_mask[:, None] == mask_values.to(torch.uint8)[:, :, None, None]  # (B, K, H, W)
    new_bbox, obj_valid = bbox_from_mask(obj_mask.flatten(0, 1))
    new_bbox, obj_valid = new_bbox.reshape(b, k, 4), obj_valid.reshape(b, k)

    zeros = torch.zeros_like(angle_deg)
    rot_z = axis_angle_to_matrix(torch.stack([zeros, zeros, angle_deg * (math.pi / 180.0)], dim=-1))
    rz = rot_z[:, None]  # (B, 1, 3, 3) over the K rows
    r_obj = axis_angle_to_matrix(rotations)
    new_rot = matrix_to_axis_angle(torch.matmul(rz, r_obj))
    new_t = torch.matmul(rz, translations[..., None])[..., 0]
    new_t = torch.cat([new_t[..., :2], new_t[..., 2:] / scale[:, None, None]], dim=-1)
    new_c = torch.matmul(coords_3d, rz.transpose(-1, -2))
    new_c = torch.cat([new_c[..., :2], new_c[..., 2:] / scale[:, None, None, None]], dim=-1)

    keep = (obj_valid & valid).any(dim=1)

    def sel(a, b):
        return torch.where(keep.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    return Augmented(sel(aug_image, images), sel(new_bbox, bboxes), sel(new_rot, rotations),
                     sel(new_t, translations), sel(new_c, coords_3d),
                     torch.where(keep[:, None], valid & obj_valid, valid), keep)


def preprocess_scale(frame_h: int, frame_w: int, target_size: int) -> float:
    """The image scale the camera-parameter vector carries."""
    return target_size / max(frame_h, frame_w)


class Batch(NamedTuple):
    """The train step's batch: preprocessed images and padded ground truth."""

    images: torch.Tensor  # (B, S, S, 3) float32
    camera_parameters: torch.Tensor  # (B, 6)
    gt_boxes: torch.Tensor  # (B, K, 4)
    gt_labels: torch.Tensor  # (B, K) int32
    gt_transformation: torch.Tensor  # (B, K, 8) [rot/pi, trans, is_sym, class]
    gt_coords_3d: torch.Tensor  # (B, K, 63)
    gt_valid: torch.Tensor  # (B, K) bool


def augment_and_preprocess_batch(raw: RawBatch, draws: Optional[AugmentDraws], image_size: int,
                                 translation_scale_norm: float = 1000.0,
                                 use_colorspace: bool = True, use_6dof: bool = True) -> Batch:
    """Colour aug -> 6-DoF warp -> resize and normalise -> label scaling: the
    batch the train step consumes.  ``draws`` None (or both augmentations
    off) preprocesses the frames as they are."""
    b, h, w, _ = raw.frames.shape
    k = raw.gt_boxes.shape[1]
    dev = raw.frames.device
    img, bboxes, rots, transs, coords, valid = (raw.frames, raw.gt_boxes, raw.gt_rotations,
                                                 raw.gt_translations, raw.gt_coords_3d, raw.gt_valid)
    if draws is not None and use_colorspace:
        img = color_augment_batch(img, draws)
    if draws is not None and use_6dof:
        cam = raw.camera_fxfycxcy
        a = augment_6dof_batch(img, raw.masks, bboxes, rots, transs, coords, valid, cam[:, 2], cam[:, 3],
                               draws.angles.to(device=dev, dtype=torch.float32),
                               draws.scales.to(device=dev, dtype=torch.float32), raw.gt_mask_values)
        on = draws.apply.to(dev)

        def sel(aug, orig):
            return torch.where(on.reshape((-1,) + (1,) * (orig.dim() - 1)), aug, orig)

        img, bboxes, rots, transs, coords, valid = (sel(a.images, img), sel(a.bboxes, bboxes),
                                                    sel(a.rotations, rots), sel(a.translations, transs),
                                                    sel(a.coords_3d, coords), sel(a.valid, valid))

    images = preprocess_uint8_batch(img, image_size)
    image_scale = preprocess_scale(h, w, image_size)
    camera_parameters = torch.cat([
        raw.camera_fxfycxcy.to(torch.float32),
        torch.full((b, 1), translation_scale_norm, dtype=torch.float32, device=dev),
        torch.full((b, 1), image_scale, dtype=torch.float32, device=dev),
    ], dim=1)
    transformation = torch.cat([rots / math.pi, transs, raw.gt_is_sym[..., None].to(torch.float32),
                                raw.gt_labels.to(torch.float32)[..., None]], dim=-1)
    return Batch(
        images=images,
        camera_parameters=camera_parameters,
        gt_boxes=(bboxes * image_scale).to(torch.float32),
        gt_labels=raw.gt_labels,
        gt_transformation=transformation.to(torch.float32),
        gt_coords_3d=(coords * image_scale).reshape(b, k, 63).to(torch.float32),
        gt_valid=valid,
    )
