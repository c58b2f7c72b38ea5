"""Model FLOPs of the window's steps (forward and the backward the step
needs, per image, times the batch) over the window's seconds, as a share
of the float32 peak outside the tensor cores (67 TFLOP/s): training runs
in float32 with TF32 off."""

from harness import arith

SOURCE, UNIT, LAYER, MOVES = "host_clock", "%", "Model step", "train_images_per_s"


def read(ctx):
    images, seconds = ctx.get("window_images"), ctx.get("window_seconds")
    if not images or not seconds:
        return None
    flops = images * arith.model_flops(ctx["widths"], ctx["image_size"], True, ctx["freeze_backbone"])
    return 100.0 * flops / seconds / arith.F32_FLOPS
