"""CUDA runtime launch calls (kernel and graph launches) per train step in
the profiled slice: 1 where each step is one graph replay."""

SOURCE, UNIT, LAYER, MOVES = "device_trace", "count", "Compiled programs", "train_images_per_s"


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("slice_steps")
    if trace is None or not steps:
        return None
    return trace.launch_calls() / steps
