"""Share of the profiled slice in which no kernel, copy or set ran on the card."""

SOURCE, UNIT, LAYER, MOVES = "device_trace", "%", "Device", "train_images_per_s"


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
