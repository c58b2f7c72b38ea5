"""Profiling: ``torch.profiler`` traces and per-stage latency histograms.

Counterpart of ``hmd_ego_pose_tpu/utils/profiler.py``.  ``profile_trace``
records host operations and, where a card is present, its kernels and copies,
and writes a Chrome trace (viewable in Perfetto or ``chrome://tracing``);
``latency_histogram`` and ``StageTimer`` summarise serving-stage latencies
with the JAX package's keys and values.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterable, Iterator, List

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


class StageTimer:
    """Accumulates named stage latencies (serving loop instrumentation)."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples.setdefault(name, []).append((time.perf_counter() - t0) * 1000)

    def report(self) -> Dict[str, Dict[str, object]]:
        return {name: latency_histogram(vals) for name, vals in self.samples.items()}
