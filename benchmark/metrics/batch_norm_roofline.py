"""The training norms' share of their roofline in the profiled slice: the
least time of a step's normalisation work (its bytes once each over 3.35
TB/s) times the steps, over the device time of the program's batch-norm
kernels (``csrc/batch_norm.cu``, by name).

The work is counted from the reference network (``reference/model.py``)
in training mode at the cell's widths, image size and batch: every batch
norm's input read once and output written once, and, at the norms whose output
needs a gradient (the BiFPN's and the heads'; with a frozen backbone not
the backbone's), the upstream gradient and the input read once and the
input gradient written once.  The swish after a norm adds no bytes.
Without such kernels in the trace (a program that normalises otherwise)
it reads nothing."""

import functools
import re

from harness import arith

KERNELS = re.compile(r"\bbn_(stats_partial|stats_sum|finalize|apply|grad_partial|grad_sum|grad_coef|grad_apply)"
                     r"_kernel\b")

SOURCE, UNIT, LAYER, MOVES = "device_trace", "%", "Kernels", "train_images_per_s"


@functools.lru_cache(maxsize=None)
def norm_sites(widths, image_size: int):
    """(name, elements per image) of every batch norm of one training forward
    of the reference network of ``widths``, counted on the meta device."""
    import torch

    from reference import shapes
    from reference.model import Net

    sites = []

    class Counting(Net):
        def bn(self, x, name, stats=None):
            sites.append((name, x[0].numel()))
            return super().bn(x, name, stats)

    P = {name: torch.empty(shape, device="meta") for name, shape in shapes.param_shapes(widths).items()}
    with torch.no_grad():
        Counting(widths, P, training=True).forward(torch.zeros((1, image_size, image_size, 3), device="meta"))
    return tuple(sites)


def norm_bytes(widths, image_size: int, batch: int, freeze_backbone: bool) -> float:
    """Bytes a training step's norms must move at least (float32)."""
    total = 0
    for name, values in norm_sites(widths, image_size):
        total += 2 * values
        if not (freeze_backbone and name.startswith("backbone/")):
            total += 3 * values
    return 4.0 * batch * total


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("slice_steps")
    if trace is None or not steps:
        return None
    took = trace.device_seconds(lambda name: bool(KERNELS.search(name)))
    if took <= 0:
        return None
    moved = norm_bytes(ctx["widths"], ctx["image_size"], ctx["batch_size"], ctx["freeze_backbone"])
    return arith.share_pct(steps * arith.bound_seconds(moved, 0.0), took)
