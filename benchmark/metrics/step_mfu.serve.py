"""Model FLOPs of the frames answered in the profiled slice (one eval
forward each, padding rows not counted) over the device's busy seconds in
the slice, as a share of the bf16 dense peak (989 TFLOP/s)."""

from harness import arith

SOURCE, UNIT, LAYER, MOVES = "device_trace", "%", "Model step", "serve_p95_ms"


def read(ctx):
    trace, frames = ctx.get("trace"), ctx.get("slice_frames")
    if trace is None or not frames or trace.busy_s <= 0:
        return None
    flops = frames * arith.model_flops(ctx["widths"], ctx["image_size"], False)
    return arith.share_pct(flops / arith.BF16_FLOPS, trace.busy_s)
