"""The host path outside the engine: the clients' round-trip median minus
the engine's own median (``stats()["total"]``: enqueue to answer).  What
the TCP handler, the I420 decode and the packet's way back take."""

SOURCE, UNIT, LAYER, MOVES = "program_span", "ms", "TCP server and frame ingest", "serve_p95_ms"


def read(ctx):
    engine = ctx.get("engine") or {}
    total, client = engine.get("total_p50_ms"), ctx.get("client_p50_ms")
    if total is None or client is None or total != total or client == float("inf"):
        return None
    return client - total
