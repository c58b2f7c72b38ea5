"""CUDA graphs: the port's counterpart of the JAX package's compiled programs.

The JAX package compiles its fixed-shape programs: the serving engine
lowers one executable per batch size before traffic
(``hmd_ego_pose_tpu/serving/engine.py::warmup``), the trainer jits the
step and scans it over an epoch, and evaluation jits its predict
(``train/step.py::make_eval_forward``).  On a CUDA card the counterpart is a
captured CUDA graph: the kernels of one call of a function, with their
arguments and memory, recorded once and replayed with one launch
(``cudaGraphLaunch``).  ``capture`` is the helper its three users share: the
serving engine (``serving/engine.py``, a graph per batch size), the
train step of every single-process path, the frame gather and colour ops
included (``train/step.py::ResidentGraph`` for the resident split and the
window buffer, ``HostGraph`` for the host pipeline), and evaluation's predict, for
``cli evaluate`` and the trainer's validation
(``train/step.py::EvalForward``, one graph in a pool of its own, captured
again when a parameter has moved):

* the function reads its inputs from static tensors that the caller fills
  before each replay, and its outputs live in the graph's memory, so a replay
  overwrites them: a caller that keeps an output past the next replay copies
  it first;
* it runs ``warmup`` times on a side stream before the capture, for real
  (its effects stand): cuDNN's plans, the constants built on first use
  (``ops/anchors.py::device_anchors``, ``ops/preprocess.py``) and an
  optimizer's state exist before the capture starts;
* the capture allocates from ``pool`` (``torch.cuda.graph_pool_handle()``),
  which graphs that are never replayed at the same time may share;
* the hand-written kernels the capture records are tallied
  (``kernels.recording``) and each replay adds them to ``kernels.LAUNCHES``;
* a capture that fails raises (``torch.cuda.graph`` reports the first
  illegal call); nothing falls back to running eagerly.

A graph cannot hold a read of device data by the host, an upload from host
memory, a shape that depends on the data, or a gloo collective.  The paths
that need one stay eager: the CPU and meshes of several processes; the
engine's and the trainer's docstrings say which.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from hmd_ego_pose_tpu_torch import kernels


class Graph:
    """One captured call: ``replay()`` runs it again; ``outputs`` is what the
    captured call returned (tensors in the graph's memory)."""

    def __init__(self, graph: torch.cuda.CUDAGraph, outputs: Any, launches: Tuple[str, ...]):
        self.graph, self.outputs, self.launches = graph, outputs, launches

    def replay(self) -> None:
        """Run the graph on the current stream; counts its kernels' launches."""
        self.graph.replay()
        for name in self.launches:
            kernels.LAUNCHES.add(name)


def capture(fn: Callable[[], Any], device: torch.device, pool: Optional[Tuple[int, int]] = None,
            warmup: int = 1) -> Graph:
    """Run ``fn()`` ``warmup`` times on a side stream of ``device``, then
    capture one call of it into a CUDA graph whose memory comes from
    ``pool`` (a private pool when None).  Raises if the capture fails."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
    with torch.cuda.device(device):
        # the side stream starts after the current stream's work, and the
        # current stream goes on after the side stream's (events: only
        # kernels.launch takes a stream)
        queued = torch.cuda.Event()
        queued.record()
        side = torch.cuda.Stream(device)
        side.wait_event(queued)
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        warmed = torch.cuda.Event()
        warmed.record(side)
        warmed.wait()
        graph = torch.cuda.CUDAGraph()
        with kernels.recording() as tally:
            # thread_local: another thread's CUDA calls neither break this
            # capture nor are broken by it
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                outputs = fn()
    return Graph(graph, outputs, tuple(tally))


def pool_bytes(pool: Tuple[int, int], device: torch.device) -> int:
    """The bytes the caching allocator holds in ``pool`` on ``device`` (the
    segments of the graphs that share it)."""
    segments = torch.cuda.memory_snapshot()
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return sum(s["total_size"] for s in segments
               if s["device"] == index and tuple(s["segment_pool_id"]) == tuple(pool))
