"""The program's spans on the device trace's clock: what the host was doing
in each of the card's idle gaps.

The program records spans on ``time.perf_counter_ns``'s clock while its
recorder is on (``hmd_ego_pose_tpu_torch/utils/profiler.py::RECORDER``; each
``Span`` has a name, start and end, thread, its id, its parent's, and the id
of its frame, batch or step).  Here they meet the device's intervals:

* ``AlignedTimeline``: a ``trace.BatchTimeline`` whose recording also
  records the spans, and an anchor event on a stream nothing else uses,
  polled until it has run before ``perf_counter_ns`` is read.  ``trace()`` keeps its
  output and carries ``aligned`` (the same CUDA event pairs placed from the
  anchor, on the spans' clock, within the wait's latency), ``spans`` and
  ``marker_behind_ms`` (how far the timeline's own marker, which goes to the
  calling thread's stream, ran behind the host's read beside it).
* ``profiled_spans(inner=trace.profiled)``: the profiled slice ``inner``
  gives, with the spans recorded and moved onto the profiler's clock by the
  offset between ``perf_counter_ns`` read inside the slice's marker and the
  marker's own timestamp; its ``Trace`` carries them as ``spans``.
* ``self_time``: each span's interval less its children's on its thread.
* ``label_gaps``: the longest idle gaps, each named ``thread:span`` by the
  span whose self time overlaps it most (working spans before the waits:
  ``WAITS``); a serving gap "no frame in the server" where the time in it
  with no frame between receive and replay is longer than any span's; a
  training gap followed by the host operation the existing breakdown names
  (``train.draws/aten::randn``).
* the readings: ``handler_ms`` (``server.recv`` + ``server.decode`` +
  ``server.send`` a frame, p50), ``dispatch_ms`` (``engine.pack`` +
  ``engine.upload`` + ``engine.replay`` a batch, p50; the upload's p50 and
  p90), ``serve_idle_split`` (the aligned slice's idle share, held while a
  frame was between ``server.recv``'s start and its batch's
  ``engine.replay`` end, and with no frame in the server),
  ``host_step_ms`` (``train.draws`` + ``train.stage`` less
  ``train.stage_wait`` a replayed step, p50) and ``train_held_idle_pct``
  (idle while the trainer's thread was in the self time of a span other
  than a wait).  ``train.replay`` counts as a wait: ``cudaGraphLaunch``
  returns about when the previous replay ends, so its span is the device's
  step, not the host's work.

Nothing here changes what the accepted metrics read: ``trace()`` and
``profiled()``'s ``Trace`` are the same objects with attributes added.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, ContextManager, Dict, Iterator, List, Optional, Sequence, Tuple

from harness import trace as tracing
from harness.arith import percentile

WAITS = ("server.wait", "engine.queue", "engine.device_wait", "train.stage_wait", "train.replay")
NO_FRAME = "no frame in the server"
NO_SPAN = "no program span"
Piece = Tuple[int, int, str]  # (start, end, "thread:span")


def _recorder():
    from hmd_ego_pose_tpu_torch.utils.profiler import RECORDER

    return RECORDER


class AlignedTimeline(tracing.BatchTimeline):
    """``BatchTimeline`` on the spans' clock (module docstring)."""

    def __init__(self, label):
        super().__init__(label)
        self.anchor = None
        self.anchor_ns = 0
        self.spans: list = []

    @contextlib.contextmanager
    def recorded(self) -> Iterator["AlignedTimeline"]:
        import torch

        self.anchor = torch.cuda.Event(enable_timing=True)
        self.anchor.record(torch.cuda.Stream())
        while not self.anchor.query():  # polled: a blocking wait can wake late
            pass
        self.anchor_ns = time.perf_counter_ns()
        rec = _recorder()
        rec.start()
        try:
            with super().recorded():
                yield self
        finally:
            self.spans = rec.stop()

    def aligned(self) -> tracing.Trace:
        """The batches' device intervals on ``perf_counter_ns``'s clock; the
        window is the host's span of the recording."""
        device = []
        for start, end, name in self.pairs:
            s = self.anchor_ns + self.anchor.elapsed_time(start) * 1e6
            e = self.anchor_ns + self.anchor.elapsed_time(end) * 1e6
            device.append((int(s), int(e), name))
        return tracing.Trace(device, [], self.t0_ns, self.t1_ns)

    def marker_behind_ms(self) -> float:
        return (self.anchor_ns + self.anchor.elapsed_time(self.marker) * 1e6 - self.t0_ns) / 1e6

    def trace(self) -> tracing.Trace:
        out = super().trace()
        out.aligned, out.spans, out.marker_behind_ms = self.aligned(), self.spans, self.marker_behind_ms()
        return out


@contextlib.contextmanager
def profiled_spans(*, inner: Callable[[], ContextManager[Dict]]) -> Iterator[Dict]:
    """``inner()`` (``trace.profiled``) with the program's spans, on the
    profiler's clock, as the ``Trace``'s ``spans`` (and the offset as
    ``clock_offset_ns``)."""
    rec = _recorder()
    rec.start()
    try:
        with inner() as box:
            t_in = time.perf_counter_ns()
            yield box
    finally:
        spans = rec.stop()
    out = box["trace"]
    offset = out.t0 - t_in
    out.clock_offset_ns = offset
    out.spans = [s._replace(start_ns=s.start_ns + offset, end_ns=s.end_ns + offset) for s in spans]


# -- intervals ----------------------------------------------------------------------


def _merge(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _subtract(s: int, e: int, holes: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out, at = [], s
    for hs, he in holes:
        if he <= at or hs >= e:
            continue
        if hs > at:
            out.append((at, hs))
        at = max(at, he)
    if at < e:
        out.append((at, e))
    return out


def _overlap(a: Sequence[Tuple[int, int]], b: Sequence[Tuple[int, int]]) -> int:
    """Length of the intersection of two merged, sorted interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(trace: tracing.Trace) -> List[Tuple[int, int]]:
    """The slice's intervals with no device interval."""
    return _subtract(trace.t0, trace.t1, trace.merged())


def self_time(spans: Sequence) -> Dict[str, List[Piece]]:
    """Each span's self time (its interval less its children's on its
    thread) as pieces labelled ``thread:name``, split into work and waits."""
    children: Dict[int, List[Tuple[int, int]]] = {}
    for s in spans:
        if s.parent:
            children.setdefault((s.parent, s.thread), []).append((s.start_ns, s.end_ns))
    out: Dict[str, List[Piece]] = {"work": [], "wait": []}
    for s in spans:
        holes = _merge(children.get((s.span_id, s.thread), []))
        kind = "wait" if s.name in WAITS else "work"
        out[kind].extend((a, b, f"{s.thread}:{s.name}") for a, b in _subtract(s.start_ns, s.end_ns, holes))
    return out


def _best_label(pieces: Sequence[Piece], g0: int, g1: int) -> Tuple[Optional[str], int]:
    """The label whose pieces overlap [g0, g1] most, and the overlap."""
    totals: Dict[str, int] = {}
    for s, e, label in pieces:
        over = min(e, g1) - max(s, g0)
        if over > 0:
            totals[label] = totals.get(label, 0) + over
    return max(totals.items(), key=lambda kv: (kv[1], kv[0])) if totals else (None, 0)


def _host_op(host: Sequence[tracing.Interval], g0: int, g1: int) -> str:
    """The host event that overlaps [g0, g1] most, as ``Trace.idle_gaps`` names it."""
    best, label = 0, "no host event traced"
    for s, e, n in host:
        over = min(e, g1) - max(s, g0)
        if over > best:
            best, label = over, n
    return label


def label_gaps(trace: tracing.Trace, spans: Sequence, empty: str, top: int = 10,
               host_ops: bool = False, held: Optional[Sequence[Tuple[int, int]]] = None) -> List[List]:
    """The ``top`` longest idle gaps as [label, seconds]: the ``thread:span``
    whose self time overlaps the gap most (a working span before a wait),
    ``empty`` where none does.  With ``held`` (merged intervals in which
    the host held work), the gap's time outside them counts for ``empty``
    and wins over a span that overlaps the gap less.  With ``host_ops``,
    "/" and the host operation that the existing breakdown names for the gap."""
    lanes = self_time(spans)
    gaps = sorted(((e - s, s, e) for s, e in idle(trace)), key=lambda g: (-g[0], g[1]))[:top]
    out = []
    for length, g0, g1 in gaps:
        label, over = _best_label(lanes["work"], g0, g1)
        free = length - _overlap([(g0, g1)], held) if held is not None else 0
        if free > over:
            label = empty
        label = label or _best_label(lanes["wait"], g0, g1)[0] or empty
        if host_ops:
            label = f"{label}/{_host_op(trace.host, g0, g1)}"
        out.append([label[:120], length / 1e9])
    return out


# -- readings -----------------------------------------------------------------------


def _sums(spans: Sequence, plus: Sequence[str], minus: Sequence[str] = (),
          needs: Optional[Sequence[str]] = None) -> List[float]:
    """Per id, the plus spans' durations less the minus spans', in ms; only
    ids that hold every span of ``needs`` (``plus`` by default)."""
    needs = plus if needs is None else needs
    per: Dict[int, Dict[str, int]] = {}
    for s in spans:
        if s.name in plus or s.name in minus or s.name in needs:
            d = per.setdefault(s.rid, {})
            d[s.name] = d.get(s.name, 0) + (s.end_ns - s.start_ns)
    return [(sum(d.get(n, 0) for n in plus) - sum(d.get(n, 0) for n in minus)) / 1e6
            for rid, d in per.items() if rid and all(n in d for n in needs)]


def _p50(values: List[float]) -> Optional[float]:
    return percentile(values, 50) if values else None


def handler_ms(spans: Sequence) -> Optional[float]:
    """The handler's own time a frame, p50: receive, decode and send."""
    return _p50(_sums(spans, ("server.recv", "server.decode", "server.send")))


def dispatch_ms(spans: Sequence) -> Optional[float]:
    """The dispatcher's host time a batch, p50: pack, upload and replay (or
    the eager batch) enqueued."""
    return _p50(_sums(spans, ("engine.pack", "engine.upload", "engine.replay")))


def upload_ms(spans: Sequence) -> Optional[Dict[str, float]]:
    ups = _sums(spans, ("engine.upload",))
    return {"p50": percentile(ups, 50), "p90": percentile(ups, 90), "batches": len(ups)} if ups else None


def _held_serve(spans: Sequence, t0: int, t1: int) -> List[Tuple[int, int]]:
    """The intervals in which at least one frame was between its
    ``server.recv`` start and its batch's ``engine.replay`` end; a frame
    received before the slice counts from its start, one not yet replayed
    to its end."""
    recv = {s.rid: s.start_ns for s in spans if s.name == "server.recv"}
    replays = [s for s in spans if s.name == "engine.replay" and s.attrs]
    done: Dict[int, int] = {}
    held = []
    for r in replays:
        for f in r.attrs.get("frames", ()):
            if f:
                done[f] = r.end_ns
            else:  # submitted before the recorder started
                held.append((t0, r.end_ns))
    for f, end in done.items():
        held.append((recv.get(f, t0), end))
    for f, start in recv.items():
        if f not in done:
            held.append((start, t1))
    return _merge([(max(s, t0), min(e, t1)) for s, e in held])


def serve_gaps(aligned: tracing.Trace, spans: Sequence, top: int = 10) -> List[List]:
    """The aligned slice's longest gaps, labelled (``label_gaps``)."""
    return label_gaps(aligned, spans, NO_FRAME, top, held=_held_serve(spans, aligned.t0, aligned.t1))


def serve_idle_split(aligned: tracing.Trace, spans: Sequence) -> Optional[Dict[str, float]]:
    """The aligned slice's idle share (%), and its parts held by a frame in
    the server and with no frame in the server."""
    if aligned.window_s <= 0 or not spans:
        return None
    gaps = idle(aligned)
    held = _overlap(gaps, _held_serve(spans, aligned.t0, aligned.t1))
    total = sum(e - s for s, e in gaps)
    window = aligned.t1 - aligned.t0
    return {"idle_pct": 100.0 * total / window, "held_pct": 100.0 * held / window,
            "no_frame_pct": 100.0 * (total - held) / window}


def host_step_ms(spans: Sequence) -> Optional[float]:
    """The host's own work a replayed step, p50: draws and staging, less
    the staging's wait for the device (the replay is a wait: ``WAITS``)."""
    return _p50(_sums(spans, ("train.draws", "train.stage"), ("train.stage_wait",), needs=("train.replay",)))


def train_held_idle_pct(trace: tracing.Trace, spans: Sequence) -> Optional[float]:
    """Idle share (%) of the profiled slice in which the trainer's thread was
    in the self time of a span other than a wait (``WAITS``)."""
    epoch = [s for s in spans if s.name == "train.epoch"]
    if trace.window_s <= 0 or not epoch:
        return None
    thread = epoch[0].thread + ":"
    busy_host = _merge([(s, e) for s, e, label in self_time(spans)["work"] if label.startswith(thread)])
    return 100.0 * _overlap(idle(trace), busy_host) / (trace.t1 - trace.t0)
