"""Batches of the window that ran eagerly because no CUDA graph held their
size (the engine's ``eager_batches``); 0 when every batch replays."""

SOURCE, UNIT, LAYER, MOVES = "program_counter", "count", "Compiled programs", "serve_p95_ms"


def read(ctx):
    return (ctx.get("engine") or {}).get("eager_batches")
