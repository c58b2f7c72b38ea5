"""``torch.cuda.max_memory_allocated()`` of the run up to the window's close,
in GB (1e9 bytes): the capture of the step's graph in set-up included,
whose pool the window's replays reuse."""

SOURCE, UNIT, LAYER, MOVES = "program_counter", "GB", "Device memory", "train_images_per_s"


def read(ctx):
    peak = ctx.get("window_peak_bytes")
    return None if not peak else peak / 1e9
