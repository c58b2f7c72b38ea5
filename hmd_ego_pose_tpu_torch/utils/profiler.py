"""Profiling: ``torch.profiler`` traces, per-stage latency histograms, spans.

Counterpart of ``hmd_ego_pose_tpu/utils/profiler.py``.  ``profile_trace``
records host operations and, where a card is present, its kernels and copies,
and writes a Chrome trace (viewable in Perfetto or ``chrome://tracing``);
``latency_histogram`` and ``StageTimer`` summarise serving-stage latencies
with the JAX package's keys and values.

``StageTimer`` is also a span recorder, and ``RECORDER`` is the process's:
the TCP handler, the engine's threads and the trainer open spans at each
layer boundary of their hot paths (``RECORDER.span(name)``), on the clock of
``time.perf_counter_ns``.  It is off by default, and off a span is one
attribute test and a shared no-op context: nothing is recorded or
allocated.  ``start()`` turns it on, ``stop()`` turns it off and returns the
spans closed in between (``Span``: name, start and end, thread, its id, its
parent's id, the id of the frame or step it belongs to, small integer
attributes).  A span opened inside another on the same thread takes the
enclosing span as its parent and the enclosing span's id and attributes,
unless it is given its own; ``current()`` hands a thread's innermost span to
work that another thread does for it.  Span names:

* ``server.recv``, ``server.decode``, ``server.wait``, ``server.send``: the
  TCP handler, one id a frame (``serving/server.py``);
* ``engine.queue`` (on the thread ``queue``: a frame's wait for the
  dispatcher, the reads of ``stats()["queue"]``), ``engine.batch`` with its
  children ``engine.pack``, ``engine.upload``, ``engine.replay`` on the
  dispatcher, ``engine.device_wait``, ``engine.fetch``, ``engine.resolve``
  on the resolver, one id a batch, whose attributes name the batch size,
  the rows filled and the frames' ids (``serving/engine.py``);
* ``train.epoch`` with ``train.indices`` and ``train.epoch_end``, and one id
  a step: ``train.step`` with ``train.draws``, ``train.stage`` (its child
  ``train.stage_wait``: the host blocked on the device) and ``train.replay``
  or ``train.capture`` (``train/trainer.py``, ``train/step.py``).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def _all_threads():
    """The profiler's option to record host operations of every thread (the
    server's work runs on the engine's threads), where this torch has it;
    None otherwise, and the host side shows the calling thread only."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def profile_trace(log_dir: str = "profile") -> Iterator[profile]:
    """Profile the block with CPU and (where a card is present) CUDA
    activities, host operations of every thread where torch can.

    Yields the ``torch.profiler.profile``; its ``key_averages()`` are readable
    after the block.  When the block ends, the Chrome trace is written to
    ``<log_dir>/trace-<pid>-<ns>.json`` and its path set as ``trace_path`` on
    the yielded profile.
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities, experimental_config=_all_threads())
    with prof:
        yield prof
    prof.trace_path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def latency_histogram(samples_ms: Iterable[float], bins: int = 20) -> Dict[str, object]:
    """Summary + histogram of latency samples for structured logging."""
    arr = np.asarray(list(samples_ms), dtype=np.float64)
    if arr.size == 0:
        return {"count": 0}
    hist, edges = np.histogram(arr, bins=bins)
    return {
        "count": int(arr.size),
        "mean_ms": float(arr.mean()),
        "p50_ms": float(np.percentile(arr, 50)),
        "p90_ms": float(np.percentile(arr, 90)),
        "p99_ms": float(np.percentile(arr, 99)),
        "max_ms": float(arr.max()),
        "hist_counts": hist.tolist(),
        "hist_edges_ms": [float(e) for e in edges],
    }


class Span(NamedTuple):
    """One closed span; ids are positive, 0 is none."""

    name: str
    start_ns: int
    end_ns: int
    thread: str
    span_id: int
    parent: int
    rid: int  # the frame's, batch's or step's id
    attrs: Optional[Dict[str, object]]


_OFF = contextlib.nullcontext()  # what ``span`` returns while the recorder is off


class _Open:
    """A span while it is open; entering it yields its id."""

    __slots__ = ("rec", "name", "rid", "parent", "attrs", "span_id", "t0", "stack")

    def __init__(self, rec: "StageTimer", name: str, rid: int, parent: int, attrs):
        self.rec, self.name, self.rid, self.parent, self.attrs = rec, name, rid, parent, attrs

    def __enter__(self) -> int:
        local = self.rec._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
        if stack:
            outer = stack[-1]
            if not self.parent:
                self.parent = outer.span_id
            if not self.rid:
                self.rid = outer.rid
                if self.attrs is None:
                    self.attrs = outer.attrs
        self.stack = stack
        self.span_id = next(self.rec._ids)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self.span_id

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        self.stack.pop()
        self.rec.add(self.name, self.t0, t1, self.rid, self.parent, self.attrs, span_id=self.span_id)


class StageTimer:
    """Accumulates named stage latencies (serving loop instrumentation), and
    records spans while it is on (module docstring)."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = {}
        self.on = False
        self._spans: List[Span] = []
        self._ids = itertools.count(1)
        self._local = threading.local()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with self.span(name):
                yield
        finally:
            self.samples.setdefault(name, []).append((time.perf_counter() - t0) * 1000)

    def report(self) -> Dict[str, Dict[str, object]]:
        return {name: latency_histogram(vals) for name, vals in self.samples.items()}

    # -- spans -------------------------------------------------------------------
    def start(self) -> None:
        """Record spans from now on (those recorded before are dropped)."""
        self._spans = []
        self.on = True

    def stop(self) -> List[Span]:
        """Stop recording; the spans closed since ``start``, by start time."""
        self.on = False
        spans, self._spans = self._spans, []
        return sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))

    def next_id(self) -> int:
        """A new frame, batch or step id; 0 while off."""
        return next(self._ids) if self.on else 0

    def span(self, name: str, rid: int = 0, parent: int = 0, attrs: Optional[Dict[str, object]] = None):
        """A context that records ``name`` from its entry to its exit while
        the recorder is on, and yields the span's id (None while off)."""
        if not self.on:
            return _OFF
        return _Open(self, name, rid, parent, attrs)

    def current(self) -> Optional[Tuple[int, int]]:
        """(id, span id) of this thread's innermost open span; None while off
        or where none is open."""
        if not self.on:
            return None
        stack = getattr(self._local, "stack", None)
        return (stack[-1].rid, stack[-1].span_id) if stack else None

    def add(self, name: str, start_ns: int, end_ns: int, rid: int = 0, parent: int = 0,
            attrs: Optional[Dict[str, object]] = None, thread: Optional[str] = None,
            span_id: Optional[int] = None) -> None:
        """Record a span whose clock reads were made elsewhere (a no-op while off)."""
        if self.on:
            self._spans.append(Span(name, start_ns, end_ns, thread or threading.current_thread().name,
                                    span_id or next(self._ids), parent, rid, attrs))


RECORDER = StageTimer()
