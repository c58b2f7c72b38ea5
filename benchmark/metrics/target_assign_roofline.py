"""``target_assign``'s share of its roofline in the profiled slice: the
least time its work could take on the card (bytes over 3.35 TB/s, or
operations over 67 TFLOP/s, the larger) times the steps, over the device
time of its kernels (two launches a step)."""

import re

from harness import arith

KERNELS = re.compile(r"\b(best_anchor_kernel|assign_kernel)\b")  # csrc/target_assign.cu

SOURCE, UNIT, LAYER, MOVES = "device_trace", "%", "Kernels", "train_images_per_s"


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("slice_steps")
    if trace is None or not steps:
        return None
    took = trace.device_seconds(lambda name: bool(KERNELS.search(name)))
    if took <= 0:
        return None
    moved, ops = arith.target_assign_work(arith.num_anchors(ctx["image_size"]), 1, ctx["batch_size"], 1)
    return arith.share_pct(steps * arith.bound_seconds(moved, ops), took)
