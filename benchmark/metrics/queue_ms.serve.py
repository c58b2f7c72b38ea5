"""The engine's queue wait, median over the window (``stats()["queue"]``):
how long a frame waits for the dispatcher, which batches across clients."""

SOURCE, UNIT, LAYER, MOVES = "program_span", "ms", "Engine", "serve_p95_ms"


def read(ctx):
    value = (ctx.get("engine") or {}).get("queue_p50_ms")
    return None if value is None or value != value else value
