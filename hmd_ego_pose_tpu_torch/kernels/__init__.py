"""Hand-written CUDA kernels: build (``build.py``), launch and launch counts.

Every kernel wrapper launches through ``launch``, which adds one to the
kernel's count where it launches it, and nowhere else, so a run can show
that a path really went through the kernel (``chip_smoke.py`` resets the
counts just before the serving and the evaluation paths and reads them just
after each).  ``launch`` makes the tensors' device the current one for the
call: a ``<<<...>>>`` launch goes to the calling thread's current device,
which need not be the tensors' (a rank on ``cuda:1`` of a process whose
current device is ``cuda:0``).

A launch made while the stream is capturing a CUDA graph runs nothing: it is
recorded into the graph, and every replay of that graph runs it.  So such a
launch is not counted; it is added to the tally of the capture in progress
(``recording``, which ``utils/graphs.py::capture`` opens), and each replay
adds that tally to ``LAUNCHES``.  A capture without an open tally raises,
so a replay never runs a kernel it does not count.  The tally is the
process's, not the capturing thread's: autograd runs a captured backward,
and so the batch norm's backward kernels, on a thread of its own.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Optional

import torch


class LaunchCounts:
    """Thread-safe per-kernel launch counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def add(self, name: str) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)


LAUNCHES = LaunchCounts()

_capture_lock = threading.Lock()
_capture_tally: Optional[List[str]] = None  # the launches of the capture in progress


@contextlib.contextmanager
def recording() -> Iterator[List[str]]:
    """Open the tally of the launches a CUDA graph capture records (one at a
    time in a process); yields the list, which holds one name per recorded
    launch."""
    global _capture_tally
    with _capture_lock:
        if _capture_tally is not None:
            raise RuntimeError("a launch tally is already open")
        _capture_tally = tally = []
    try:
        yield tally
    finally:
        with _capture_lock:
            _capture_tally = None


def launch(name: str, function: str, device: torch.device, *args) -> None:
    """Call ``function`` of ``csrc/<name>.cu``'s library with ``args`` and the
    current stream of ``device``, with ``device`` the current device; raises
    on a launch error, else counts one launch of ``name`` (during a capture:
    adds it to the capture's tally)."""
    from hmd_ego_pose_tpu_torch.kernels import build

    lib = build.library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, function)(*args, stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    if not capturing:
        LAUNCHES.add(name)
        return
    with _capture_lock:
        if _capture_tally is None:
            raise RuntimeError(f"{name} launched into a CUDA graph capture without a launch tally "
                               "(capture through utils/graphs.py::capture)")
        _capture_tally.append(name)
