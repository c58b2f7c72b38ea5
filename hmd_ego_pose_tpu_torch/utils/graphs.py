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
train step of every path, the frame gather and colour ops
included (``train/step.py::ResidentGraph`` for the resident split and the
window buffer, ``HostGraph`` for the host pipeline), and evaluation's predict, for
``cli evaluate`` and the trainer's validation
(``train/step.py::EvalForward``, one graph in a pool of its own, captured
again when a parameter has moved):

* the function reads its inputs from static tensors that the caller fills
  before each replay, and its outputs live in the graph's memory, so a replay
  overwrites them: a caller that keeps an output past the next replay copies
  it first;
* it runs ``warmup`` (at least 1) times on a side stream before the
  capture, for real (its effects stand): cuDNN's plans, the constants built
  on first use (``ops/anchors.py::device_anchors``, ``ops/preprocess.py``),
  an optimizer's state and the NCCL communicator of every group a
  collective of the function uses (a communicator first used inside a
  capture cannot be made there) exist before the capture starts;
* the capture allocates from ``pool`` (``torch.cuda.graph_pool_handle()``),
  which graphs that are never replayed at the same time may share; the
  buffers a collective packs or gathers into are the graph's, as every other
  temporary of the captured call;
* the hand-written kernels the capture records are tallied
  (``kernels.recording``) and each replay adds them to ``kernels.LAUNCHES``;
  so are the mesh's collectives (``parallel/mesh.py::recording``), which
  each replay adds to their mesh's ``CollectiveStats``;
* a capture that fails raises (``torch.cuda.graph`` reports the first
  illegal call); nothing falls back to running eagerly.

A graph cannot hold a read of device data by the host, an upload from host
memory, a shape that depends on the data, or a gloo collective (gloo's go
through the host).  Meshes: a graph holds the NCCL collectives of a mesh
that ``DataMesh.capturable`` allows (NCCL, a card per rank, any axes), so
there these are captured on every rank, in the same order (two ranks
replaying their graphs in different orders would wait on each other on
the card, where no timeout reaches them):

* the train step: BN's statistics and their backward, the gradients' and
  the losses' means, and on a space axis the halo exchanges, gathers and
  space sums of ``parallel/spatial.py`` with their backward and BN over
  (data x space);
* the engine's whole batch: the frame broadcasts, the rank's slab of its
  rows, the predict (on a space axis its halos and gathered heads) and the
  pose gather;
* evaluation's predict (``EvalForward``), on a space axis with its halos
  and gathers.

A predict that makes no collective (eval mode, no space axis) is captured
on any mesh, gloo included: evaluation's, and the engine's preprocess and
predict of a gloo rank's rows between its eager broadcasts and gather.
What stays eager: the CPU, a gloo mesh's train step and collectives, and a
gloo mesh's space axis (train step, predict and engine); the engine's and
the trainer's docstrings say which.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from hmd_ego_pose_tpu_torch import kernels
from hmd_ego_pose_tpu_torch.parallel import mesh


class Graph:
    """One captured call: ``replay()`` runs it again; ``outputs`` is what the
    captured call returned (tensors in the graph's memory); ``launches`` and
    ``collectives`` what it records (a kernel's name; a mesh's stats and a
    collective's kind)."""

    def __init__(self, graph: torch.cuda.CUDAGraph, outputs: Any, launches: Tuple[str, ...],
                 collectives: Tuple[Tuple[mesh.CollectiveStats, str], ...] = ()):
        self.graph, self.outputs, self.launches, self.collectives = graph, outputs, launches, collectives

    def replay(self) -> None:
        """Run the graph on the current stream; counts its kernels' launches
        and its collectives."""
        self.graph.replay()
        for name in self.launches:
            kernels.LAUNCHES.add(name)
        for stats, kind in self.collectives:
            stats.replayed(kind)


def capture(fn: Callable[[], Any], device: torch.device, pool: Optional[Tuple[int, int]] = None,
            warmup: int = 1) -> Graph:
    """Run ``fn()`` ``warmup`` times on a side stream of ``device``, then
    capture one call of it into a CUDA graph whose memory comes from
    ``pool`` (a private pool when None), its kernels and collectives tallied.
    Raises if the capture fails."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
    if warmup < 1:
        raise ValueError(f"the capture needs a warm-up call, got warmup={warmup}")
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
        with kernels.recording() as launches, mesh.recording() as collectives:
            # thread_local: another thread's CUDA calls (a process group's
            # watchdog among them) neither break this capture nor are broken by it
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                outputs = fn()
    return Graph(graph, outputs, tuple(launches), tuple(collectives))


def pool_bytes(pool: Tuple[int, int], device: torch.device) -> int:
    """The bytes the caching allocator holds in ``pool`` on ``device`` (the
    segments of the graphs that share it)."""
    segments = torch.cuda.memory_snapshot()
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return sum(s["total_size"] for s in segments
               if s["device"] == index and tuple(s["segment_pool_id"]) == tuple(pool))
