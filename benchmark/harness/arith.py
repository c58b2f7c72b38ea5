"""The benchmark's yardstick: published peaks, operation and byte counts.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W):
989 TFLOP/s in bfloat16, 67 TFLOP/s in float32 outside the tensor cores,
3.35 TB/s of HBM.  A share of a peak is stated against these, with the
card's power limit beside it.

* ``model_flops``: the FLOPs of the reference network (``reference/model.py``)
  at a configuration's widths and image size, its forward counted by
  ``torch.utils.flop_counter.FlopCounterMode`` on the meta device (2 per
  multiply-add of every convolution and matrix product):
  one eval forward per served frame; per trained image the forward plus the
  backward the step needs.  With a frozen backbone no gradient reaches the
  backbone: the backward covers the BiFPN and the heads, their weight and
  input gradients (the input gradients of the six 1x1 convolutions that read
  the backbone's features are counted though not needed), and nothing below
  P3-P5.
* ``target_assign_work``: bytes and operations of the target assignment of
  one batch, the formula of the program's ``kernels/bounds.py`` copied
  here: the anchors and padded ground truth read once, the five per-anchor
  targets written once.
"""

from __future__ import annotations

import functools
import math
import statistics
from typing import Optional, Sequence, Tuple

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics; an
    infinite value (a missing answer) sorts last."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    if xs[hi] == float("inf"):
        return float("inf") if pos > lo or xs[lo] == float("inf") else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """Interquartile distance as a share of the median (``statistics.quantiles``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


@functools.lru_cache(maxsize=None)
def forward_flops(widths, image_size: int, part: str = "network") -> float:
    """FLOPs of one eval forward of one image through the reference network
    of ``widths`` (``reference/model.py``'s ``Widths``; ``part`` "network")
    or its backbone alone ("backbone"), counted by ``FlopCounterMode`` on
    the meta device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from reference import shapes
    from reference.model import Net

    P = {name: torch.empty(shape, device="meta") for name, shape in shapes.param_shapes(widths).items()}
    stats = {}
    for prefix, c in shapes.stat_names(widths).items():
        stats[prefix + "/mean"] = torch.zeros(c, device="meta")
        stats[prefix + "/var"] = torch.ones(c, device="meta")
    x = torch.zeros((1, image_size, image_size, 3), device="meta")
    net = Net(widths, P, stats)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        if part == "backbone":
            net.backbone(x.permute(0, 3, 1, 2))
        else:
            net.forward(x)
    return float(counter.get_total_flops())


def model_flops(widths, image_size: int, training: bool, freeze_backbone: bool = True) -> float:
    """FLOPs per image: an eval forward; or in training the forward plus the
    backward, two forwards' worth (the weight and the input gradients) of
    every trained layer: the BiFPN and the heads with a frozen backbone.
    ``FlopCounterMode`` is not asked for the backward: it counts a grouped
    (depthwise) convolution's backward about 32 times too high."""
    total = forward_flops(widths, image_size)
    if not training:
        return total
    trained = total - forward_flops(widths, image_size, "backbone") if freeze_backbone else total
    return total + 2.0 * trained


def target_assign_work(n: int, k: int, batch: int, num_classes: int, dt: int = 8, dc: int = 63
                       ) -> Tuple[float, float]:
    """(bytes, operations) of one batch's target assignment over ``n``
    anchors and ``k`` padded objects."""
    gt_bytes = batch * k * ((4 + 1 + dt + dc) * 4 + 1)
    out_bytes = batch * n * (num_classes + 4 + dt + dc + 1) * 4
    return n * 4 * 4 + gt_bytes + out_bytes, batch * n * (k * 17 + 20)


def bound_seconds(moved: float, ops: float, flops: float = F32_FLOPS) -> float:
    return max(moved / HBM_BYTES_PER_S, ops / flops)


def share_pct(least_s: float, took_s: float) -> Optional[float]:
    """100 x least / took, or None where nothing was timed."""
    if took_s <= 0:
        return None
    return 100.0 * least_s / took_s


def num_anchors(image_size: int) -> int:
    return sum(9 * (-(-image_size // 2 ** lv)) ** 2 for lv in range(3, 8))
