"""The program's spans in a cell's run, and the check of their clock, on the card.

    python benchmark/tools/spans.py cell --workload W --seed N --seconds S --spans slice|window
    python benchmark/tools/spans.py clock [--repeats 20]

``cell``: one run of the cell, as ``benchmark/run.py`` makes it, with the
program's span recorder on for the traced slice (``slice``: the run is
traced; the serving slice's ``BatchTimeline`` is ``harness/spans.py``'s
``AlignedTimeline``, the training slice is ``profiled_spans``) or for the
whole of an untraced run (``window``: set-up included, to time what
recording costs).  One JSON line: the end-to-end metrics, ``correct``, the
accepted per-layer metrics as their readers read them, and from the spans
the five readings of ``harness/spans.py`` (``handler_ms.serve``,
``dispatch_ms.serve``, ``host_held_idle_pct.serve``, ``host_step_ms.train``,
``host_held_idle_pct.train``), the idle split, the labelled gaps and the
agreement of the spans with the engine's own statistics.  The harness's
``trace.BatchTimeline`` and ``trace.profiled`` are swapped for the span
versions at run time; once ``harness/serve.py`` and ``harness/train.py``
use those themselves, ``cell`` goes.

``clock``: on the engine's stream (the default stream) a spin kernel, the
host polling its end, a span around 5 ms of host time (a sleep, or a busy
wait in every other repetition) that ends once the next kernel's start
event is enqueued, that kernel; the aligned trace's gap must fall under
the span's label, its edges within 0.1 ms of the span's
(``within_0_1_ms``).  The events are made before the recording, so the
span's end is the enqueue alone.  Beside it, the latency from a host read
to an event recorded on the idle stream.  One JSON line with the errors.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from harness import common, spans  # noqa: E402
from harness import trace as tracing  # noqa: E402
from harness.arith import percentile  # noqa: E402


def _p(values, q=50):
    return percentile(values, q) if values else None


def serve_readings(trace, engine_view):
    got = trace.spans
    aligned = trace.aligned
    split = spans.serve_idle_split(aligned, got)
    by_rid = {}
    for s in got:
        by_rid.setdefault(s.rid, {})[s.name] = s
    batch_of = {f: s.rid for s in got if s.name == "engine.batch" for f in s.attrs["frames"] if f}
    totals, late = [], []  # the engine's ``total`` per frame (enqueue -> resolve), the wait's excess over it
    for rid, named in by_rid.items():
        q, wait = named.get("engine.queue"), named.get("server.wait")
        resolve = by_rid.get(batch_of.get(rid), {}).get("engine.resolve")
        if q is not None and resolve is not None:
            totals.append((resolve.start_ns - q.start_ns) / 1e6)
            if wait is not None:
                late.append((wait.end_ns - wait.start_ns - (resolve.start_ns - q.start_ns)) / 1e6)
    waits = [(s.end_ns - s.start_ns) / 1e6 for s in got if s.name == "server.wait"]
    queues = [(s.end_ns - s.start_ns) / 1e6 for s in got if s.name == "engine.queue"]
    return {
        "handler_ms.serve": spans.handler_ms(got),
        "dispatch_ms.serve": spans.dispatch_ms(got),
        "host_held_idle_pct.serve": split and split["held_pct"],
        "idle_split": split,
        "upload_ms": spans.upload_ms(got),
        "span_p50_ms": {n: _p([(s.end_ns - s.start_ns) / 1e6 for s in got if s.name == n])
                        for n in sorted({s.name for s in got})},
        "server_wait_p50_ms": _p(waits), "total_from_spans_p50_ms": _p(totals),
        "wait_over_total_ms": {"p50": _p(late), "p90": _p(late, 90), "max": max(late) if late else None},
        "engine_total_p50_ms": engine_view.get("total_p50_ms"),
        "engine_queue_span_p50_ms": _p(queues), "queue_ms.serve": engine_view.get("queue_p50_ms"),
        "marker_behind_ms": trace.marker_behind_ms,
        "aligned_busy_s": aligned.busy_s, "aligned_window_s": aligned.window_s,
        "idle_gaps": spans.serve_gaps(aligned, got),
        "spans": len(got), "frames": len({s.rid for s in got if s.name == "server.recv"}),
    }


def train_readings(trace):
    got = trace.spans
    return {
        "host_step_ms.train": spans.host_step_ms(got),
        "host_held_idle_pct.train": spans.train_held_idle_pct(trace, got),
        "span_p50_ms": {n: _p([(s.end_ns - s.start_ns) / 1e6 for s in got if s.name == n])
                        for n in sorted({s.name for s in got})},
        "clock_offset_ns": trace.clock_offset_ns,
        "idle_gaps": spans.label_gaps(trace, got, spans.NO_SPAN, host_ops=True),
        "spans": len(got), "steps": len({s.rid for s in got if s.name == "train.step"}),
    }


def run_cell(args) -> dict:
    from hmd_ego_pose_tpu_torch.utils.profiler import RECORDER

    bench = common.benchmark()
    cell = common.cell(args.workload, bench)
    kind = cell["traffic"]["kind"]
    trace = args.spans == "slice"
    if trace:
        tracing.BatchTimeline = spans.AlignedTimeline
        tracing.profiled = functools.partial(spans.profiled_spans, inner=tracing.profiled)
    runner = importlib.import_module("harness." + kind)
    if not trace:
        RECORDER.start()
    try:
        out = runner.run(cell, args.seed, args.seconds, trace)
    finally:
        window_spans = RECORDER.stop()
    line = {"workload": args.workload, "seed": args.seed, "spans_on": args.spans, "trace": int(trace),
            "correct": bool(out["correct"]), "e2e": out["e2e"], "checks": out["checks"]}
    if trace and out["trace"] is not None:
        wanted = common.metrics_for(bench, cell["workload"])["per_layer"]
        line["per_layer"] = {m["name"]: common.metric_reader(m["name"]).read(out["ctx"]) for m in wanted}
        line["breakdown_idle_gaps"] = out["trace"].idle_gaps()
        line["busy_s"], line["window_s"] = out["trace"].busy_s, out["trace"].window_s
        line["spans"] = (serve_readings(out["trace"], out["ctx"]["engine"]) if kind == "serve"
                         else train_readings(out["trace"]))
    if not trace:  # set-up's spans too: the run's whole
        got = window_spans
        line["window_spans"] = len(got)
        line["window_span_p50_ms"] = {n: _p([(s.end_ns - s.start_ns) / 1e6 for s in got if s.name == n])
                                      for n in sorted({s.name for s in got})}
        line["window_readings"] = ({"handler_ms": spans.handler_ms(got), "dispatch_ms": spans.dispatch_ms(got),
                                    "upload_ms": spans.upload_ms(got)} if kind == "serve"
                                   else {"host_step_ms": spans.host_step_ms(got)})
    if kind == "serve":
        line["engine"] = out["ctx"]["engine"]
    else:
        line["epoch_edge"] = out["extra"].get("epoch_edge")
    return line


def clock(repeats: int) -> dict:
    """Kernel, host wait, a span around 5 ms of host time that ends once the
    next kernel's start is enqueued, kernel; the aligned trace's gap against
    the span, ``repeats`` times."""
    import torch

    from hmd_ego_pose_tpu_torch.utils.profiler import RECORDER

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)  # warm
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    b.synchronize()
    spin = int(10 ** 7 / a.elapsed_time(b))  # cycles in ~1 ms
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5 * repeats)]
    side = torch.cuda.Stream()
    for ev in events:  # each event's first record creates it: done here, before the recording
        ev.record(side)
    side.synchronize()
    events = iter(events)
    timeline = spans.AlignedTimeline(lambda cycles: "spin")

    def kernel(start):
        end = next(events)
        torch.cuda._sleep(spin)
        end.record()
        timeline.pairs.append((start, end, "spin"))
        return end

    enqueued = []  # a host read just before each second kernel's start event is enqueued
    with timeline.recorded():
        for k in range(repeats):
            first = next(events)
            first.record()
            done = kernel(first)
            while not done.query():
                pass
            with RECORDER.span("clock.host", RECORDER.next_id(), 0, {"busy": k % 2}):
                if k % 2:
                    until = time.perf_counter_ns() + 5 * 10 ** 6
                    while time.perf_counter_ns() < until:
                        pass
                else:
                    time.sleep(0.005)
                second = next(events)
                enqueued.append(time.perf_counter_ns())
                second.record()
            kernel(second)
        torch.cuda.synchronize()
        marks = []  # an event recorded on the idle stream right after a host read: the submission's latency
        for _ in range(repeats):
            ev = next(events)
            t_host = time.perf_counter_ns()
            ev.record()
            while not ev.query():
                pass
            marks.append((t_host, ev))
    tr = timeline.trace()
    submit = sorted((timeline.anchor_ns + timeline.anchor.elapsed_time(ev) * 1e6 - t) / 1e6 for t, ev in marks)
    aligned, got = tr.aligned, tr.spans
    gaps = spans.idle(aligned)
    rows = []
    for s, t_enq in zip((s for s in got if s.name == "clock.host"), enqueued):
        gap = max(gaps, key=lambda g: min(g[1], s.end_ns) - max(g[0], s.start_ns))
        rows.append({"busy": s.attrs["busy"], "start_err_ms": (s.start_ns - gap[0]) / 1e6,
                     "end_err_ms": (gap[1] - s.end_ns) / 1e6, "enqueue_to_start_ms": (gap[1] - t_enq) / 1e6,
                     "label": spans.label_gaps(tracing.Trace(aligned.device, [], gap[0], gap[1]), got, "none", 1)[0][0]})
    worst = max(max(abs(r["start_err_ms"]), abs(r["end_err_ms"])) for r in rows)
    return {"clock": rows, "worst_edge_err_ms": worst, "within_0_1_ms": worst <= 0.1,
            "labels_ok": all(r["label"] == "MainThread:clock.host" for r in rows),
            "start_err_ms": sorted(r["start_err_ms"] for r in rows),
            "end_err_ms": {mode: sorted(r["end_err_ms"] for r in rows if r["busy"] == k)
                           for k, mode in ((0, "after_sleep"), (1, "after_busy_wait"))},
            "submit_ms": {"min": submit[0], "p50": submit[len(submit) // 2], "max": submit[-1]},
            "marker_behind_ms": tr.marker_behind_ms, "spin_cycles": spin}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("cell", "clock"))
    parser.add_argument("--workload")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--seconds", type=int, default=51)
    parser.add_argument("--spans", choices=("slice", "window"), default="slice")
    parser.add_argument("--repeats", type=int, default=20)
    args = parser.parse_args()
    common.set_cache_dirs()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = clock(args.repeats) if args.what == "clock" else run_cell(args)
    line["card"] = common.power_limit()
    print(json.dumps(common._finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
