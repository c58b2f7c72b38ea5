"""Hand-written CUDA kernels: build (``build.py``) and launch counts.

Each kernel wrapper adds one to its count where it launches its kernel, and
nowhere else, so a run can show that a path really went through the kernel
(``chip_smoke.py`` resets the counts just before the serving and the
evaluation paths and reads them just after each).
"""

from __future__ import annotations

import threading
from typing import Dict


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
