"""A profiled slice of the window, reduced to what the per-layer metrics read.

``profiled()`` runs ``torch.profiler`` (host and CUDA activities) around a
slice of the measured window and keeps, from its events, the device
intervals (kernels, copies, sets) and the host events: the calling
thread's operations and every thread's CUDA runtime calls.  The slice is
bounded by a marker on the calling thread.  ``Trace`` reduces them:

* ``busy_s``: the union of the device intervals within the slice;
* ``window_s``: the slice's length, from its marker on the host;
* ``launch_calls``: kernel and graph launch calls of the runtime;
* ``device_ops``: the device operations that took most time, by name;
* ``idle_gaps``: the longest gaps with no device interval, each labelled by
  the host event that overlaps it most (a runtime call or an operation).

``BatchTimeline`` makes the same ``Trace`` from CUDA events recorded around
each of a server's batches, where the profiler cannot follow the server.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaLaunchCooperativeKernel")

Interval = Tuple[int, int, str]
SLICE = "benchmark.slice"


class Trace:
    def __init__(self, device: List[Interval], host: List[Interval], t0: int, t1: int):
        self.device = sorted(device)
        self.host = host
        self.t0, self.t1 = t0, t1

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def merged(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for s, e, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e9

    def launch_calls(self, names=LAUNCH_CALLS) -> int:
        return sum(1 for _, _, n in self.host if n in names)

    def device_ops(self, top: int = 10) -> List[List]:
        total: Dict[str, int] = {}
        for s, e, n in self.device:
            total[n] = total.get(n, 0) + (e - s)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:120], ns / 1e9] for n, ns in ranked]

    def device_seconds(self, match) -> float:
        """Device seconds of the intervals whose name ``match(name)`` accepts."""
        return sum(e - s for s, e, n in self.device if match(n)) / 1e9

    def idle_gaps(self, top: int = 10) -> List[List]:
        busy = self.merged()
        gaps = []
        edges = [(self.t0, self.t0)] + busy + [(self.t1, self.t1)]
        for (_, e0), (s1, _) in zip(edges[:-1], edges[1:]):
            if s1 > e0:
                gaps.append((s1 - e0, e0, s1))
        gaps.sort(key=lambda g: (-g[0], g[1]))
        host = sorted(self.host)
        out = []
        for length, g0, g1 in gaps[:top]:
            best, label = 0, "no host event traced"
            for s, e, n in host:
                if s >= g1:
                    break
                overlap = min(e, g1) - max(s, g0)
                if overlap > best:
                    best, label = overlap, n
            out.append([label[:120], length / 1e9])
        return out


def _events(prof) -> Tuple[List[Interval], List[Interval]]:
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s, name = ev.start_ns(), ev.name()
        item = (s, s + ev.duration_ns(), name)
        if ev.device_type() != DeviceType.CUDA:
            host.append(item)
        elif name != SLICE:  # the marker's own range on the device's row is no device work
            device.append(item)
    return device, host


@contextlib.contextmanager
def profiled() -> Iterator[Dict[str, Optional[Trace]]]:
    """Profile the block; ``box["trace"]`` holds its ``Trace`` afterwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    box: Dict[str, Optional[Trace]] = {"trace": None}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        with torch.profiler.record_function(SLICE):
            yield box
            torch.cuda.synchronize()
    device, host = _events(prof)
    mark = [(s, e) for s, e, n in host if n == SLICE]
    if not mark:
        raise RuntimeError("the profile holds no slice marker")
    box["trace"] = Trace(device, [h for h in host if h[2] != SLICE], mark[0][0], mark[0][1])


class BatchTimeline:
    """The device's timeline of a multi-threaded server's batches, from CUDA
    events: ``wrap(fn)`` records an event on the calling thread's stream
    before and after each call of ``fn`` (the call that uploads a batch and
    enqueues its work), while ``recording`` is on.  ``trace()`` turns the
    pairs into device intervals against a marker event recorded when the
    recording started.  ``torch.profiler`` stalls the serving engine's
    threads on the card this benchmark runs on (PERF.md), so the serving
    cells take their device time from these events."""

    def __init__(self, label):
        self.label = label
        self.pairs: List = []
        self.recording = False
        self.marker = None
        self.t0_ns = self.t1_ns = 0

    def wrap(self, fn):
        import torch

        def timed(*args):
            if not self.recording:
                return fn(*args)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.pairs.append((start, end, self.label(*args)))
            return out

        return timed

    @contextlib.contextmanager
    def recorded(self) -> Iterator["BatchTimeline"]:
        import time

        import torch

        self.marker = torch.cuda.Event(enable_timing=True)
        self.marker.record()
        self.t0_ns = time.perf_counter_ns()
        self.recording = True
        try:
            yield self
        finally:
            self.recording = False
            self.t1_ns = time.perf_counter_ns()
            torch.cuda.synchronize()

    def trace(self) -> Trace:
        """Device intervals in ns from the marker; the window is the host's
        span of the recording (the marker runs when it is recorded: the
        stream it goes to is the main thread's, idle)."""
        device = []
        for start, end, name in self.pairs:
            s = self.marker.elapsed_time(start) * 1e6
            e = self.marker.elapsed_time(end) * 1e6
            device.append((int(s), int(e), name))
        return Trace(device, [], 0, self.t1_ns - self.t0_ns)
