"""Metric logging: JSONL always, TensorBoard when ``torch.utils.tensorboard`` imports.

Counterpart of ``hmd_ego_pose_tpu/utils/logging.py``: one JSON record per
``log_scalars`` call in ``<log_dir>/metrics-<name>.jsonl`` (step, wall
time, scalars), the same scalars to TensorBoard where its writer imports,
and a one-line summary on stdout.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, log_dir: str = "runs", name: Optional[str] = None, stdout: bool = True):
        self.log_dir = log_dir
        self.stdout = stdout
        os.makedirs(log_dir, exist_ok=True)
        stamp = name or time.strftime("%Y%m%d-%H%M%S")
        self.jsonl_path = os.path.join(log_dir, f"metrics-{stamp}.jsonl")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is not installed
            SummaryWriter = None
        if SummaryWriter is not None:
            self._tb = SummaryWriter(os.path.join(log_dir, stamp))

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        record = {"step": step, "time": time.time(), **{k: float(v) for k, v in scalars.items()}}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)
        if self.stdout:
            parts = " ".join(f"{k}={float(v):.4g}" for k, v in scalars.items())
            print(f"[step {step}] {parts}", flush=True)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
