"""Batched streaming inference engine on one CUDA device, or on a mesh of ranks.

Counterpart of ``hmd_ego_pose_tpu/serving/engine.py``.  Raw uint8 frames go
to the device, where preprocess, the forward pass, decode and NMS run; only
the best pose of each frame comes back.
Requests from any number of clients are batched adaptively: the dispatcher
drains the queue (up to ``max_batch_size``), pads to the next power of two
and runs one batch.  Two threads form a double buffer: the dispatcher
enqueues a batch on the device without waiting, the resolver waits for it,
copies the result to the host and resolves the futures.

Per-stage latency (``stats()``, the JAX engine's keys): ``queue`` wait,
``execute`` (dispatch done -> device done), ``fetch`` (device -> host copy),
``device`` (batch start -> results on the host) and ``total`` per request.
While ``utils/profiler.py::RECORDER`` is on, the engine records spans from
the same clock reads: ``engine.queue`` per request (its frame's id and the
submitting thread's open span, ``server.wait`` in the server, as its
parent), and per batch ``engine.batch`` (``engine.pack``, ``engine.upload``,
``engine.replay``) on the dispatcher and ``engine.device_wait``,
``engine.fetch``, ``engine.resolve`` on the resolver, under one batch id
whose attributes hold the batch size, the rows filled and the frames' ids
(0 for a frame submitted before the recorder started).

Pose packet contract: axis-angle radians (network output x pi) and
translation in meters (network output mm / 1000).

Compiled programs.  The JAX engine compiles one fixed-batch executable
before traffic (``warmup``) and serves through it (``_predict_aot``),
falling back to ``jit`` for a shape it never compiled.  On a CUDA card, in a
single process, this engine's ``warmup`` captures one CUDA graph per entry of
``batch_sizes`` (``utils/graphs.py``): preprocess -> ``predict`` -> the
packed (num_valid, rotation, translation), from static frame and camera
buffers, all graphs in one memory pool (``graph_pool_bytes``; the capture
takes ``capture_s``).  A batch is copied into its size's static buffers and
the graph replayed; its outputs are copied on the stream into tensors the
batch owns before the next batch can replay the same graph, since two
batches are in flight at once.  A batch size without a graph runs eagerly,
as the JAX engine's ``jit`` does, and counts in ``eager_batches`` (an
engine that holds no graph counts none).  On a mesh (``capture_mode``):
where a graph can hold its collectives (``DataMesh.capturable``: NCCL, a
card per rank, any axes) each graph holds the whole batch, the frame
broadcasts -> preprocess -> the cut of the process's data rows and slab
-> ``predict`` (on a space axis its halo exchanges and gathers) -> the
pose gather, captured by every process's ``warmup`` in the same order
("batch"); on a gloo mesh without a space axis the broadcasts and the
gather stay eager around a graph of the preprocess and ``predict`` of the
process's rows ("rows").  It stays eager on the CPU and on a gloo mesh
with a space axis (whose halo exchanges go through the host).  The JAX
engine keeps one fixed
batch size; this one keeps the powers of two up to ``max_batch_size`` (five
graphs at 16), as it has batched since its first version.

``mesh`` (a ``parallel/mesh.py::DataMesh``; the JAX engine's ``mesh``):
frames over ``data``, the image height over ``space``, the model replicated
(broadcast from process 0 and its digest checked), every batch size a
multiple of the data-axis size.  Every process builds the engine.  Process 0
owns the queue, the threads and whatever serves it (``start``, ``submit``,
``stop``); every process calls ``warmup`` (which captures on every
process; where nothing is captured, the followers' is a no-op: process 0's
warm-up batches reach them through ``follow``), then every other process
calls ``follow()``, which serves until process 0 stops, replaying the
graphs its warm-up captured.  Each batch is broadcast from process 0 (a
command, which the followers read on the host and so stays eager, then
the frames and cameras); every process preprocesses its data rows, takes
its slab of their rows and runs ``predict`` on the mesh; the poses of the
data rows are all-gathered over ``data``, and process 0 returns them.
An idle process 0 broadcasts a heartbeat every ``HEARTBEAT_S``, so a
follower's wait is bounded by the process group's timeout, and a follower
whose process 0 is gone raises instead of hanging; a broadcast that fails on
process 0 is kept in ``follower_error``, and the next batch fails its
requests.  A single process is the mesh of one (``LOCAL``, the default):
every broadcast and gather is then a no-op, and no command is sent.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hmd_ego_pose_tpu_torch.config import ModelConfig, ServingConfig
from hmd_ego_pose_tpu_torch.models import hmd_ego_pose
from hmd_ego_pose_tpu_torch.models.folding import fold_batch_norms
from hmd_ego_pose_tpu_torch.ops.preprocess import preprocess_uint8_batch
from hmd_ego_pose_tpu_torch.parallel.mesh import LOCAL, DataMesh, replicate
from hmd_ego_pose_tpu_torch.utils import graphs
from hmd_ego_pose_tpu_torch.utils.device import DeviceLike, resolve_device
from hmd_ego_pose_tpu_torch.utils.profiler import RECORDER

# commands process 0 broadcasts to the followers of a mesh engine
_STOP, _BATCH, _IDLE = 0, 1, 2
HEARTBEAT_S = 1.0


class _Request:
    __slots__ = ("frame", "camera", "future", "t_enqueue", "trace")

    def __init__(self, frame, camera):
        self.frame = frame
        self.camera = camera
        self.future: Future = Future()
        self.trace = RECORDER.current()  # (frame id, parent span id) while spans are recorded
        self.t_enqueue = time.perf_counter_ns()


def _batch_attrs(reqs: List[_Request], b: int) -> Dict[str, object]:
    """A batch span's attributes: its size, the rows filled, the frames' ids."""
    return {"batch": b, "rows": len(reqs), "frames": tuple(r.trace[0] if r.trace else 0 for r in reqs)}


class LatencyStats:
    """Streaming percentile tracker (fixed-size reservoir)."""

    def __init__(self, capacity: int = 2048, seed: int = 0):
        self.capacity = capacity
        self.samples: List[float] = []
        self.count = 0
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def record(self, value_ms: float):
        with self._lock:
            self.count += 1
            if len(self.samples) < self.capacity:
                self.samples.append(value_ms)
            else:
                j = int(self._rng.integers(0, self.count))
                if j < self.capacity:
                    self.samples[j] = value_ms

    def percentile(self, p: float) -> float:
        with self._lock:
            if not self.samples:
                return float("nan")
            return float(np.percentile(self.samples, p))

    def summary(self) -> Dict[str, float]:
        return {
            "p50_ms": self.percentile(50),
            "p90_ms": self.percentile(90),
            "p99_ms": self.percentile(99),
            "count": self.count,
        }


class InferenceEngine:
    """Adaptive-batching pose inference on one device, or on a mesh of ranks."""

    def __init__(
        self,
        model: hmd_ego_pose.HMDEgoPose,
        model_config: ModelConfig,
        serving_config: ServingConfig = ServingConfig(),
        frame_shape: Tuple[int, int] = (480, 480),
        default_camera: Optional[np.ndarray] = None,
        device: DeviceLike = None,
        mesh: DataMesh = LOCAL,
    ):
        """``model``: an eval-mode ``HMDEgoPose`` with restored weights; the
        engine serves a BN-folded copy of it (``models/folding.py``).
        ``default_camera``: (6,) [fx, fy, px, py, tz_scale, image_scale] for
        requests without intrinsics.  ``mesh``: see the module docstring;
        every process of it must build the engine at once."""
        self.device = resolve_device(device)
        self.model = fold_batch_norms(model.to(self.device).eval())
        self.mesh = mesh
        self.leader = mesh.process_rank == 0
        self._followers = mesh.processes > 1  # commands go out only to other processes
        self.follower_error: Optional[BaseException] = None  # a failed broadcast to the followers
        replicate(mesh, self.model)
        self.model_config = model_config
        self.cfg = serving_config
        self.frame_shape = frame_shape
        self._default_camera_override = (
            np.asarray(default_camera, np.float32) if default_camera is not None else None
        )
        self.batch_sizes = [2 ** i for i in range(int(math.log2(serving_config.max_batch_size)) + 1)]
        if self.batch_sizes[-1] < serving_config.max_batch_size:
            self.batch_sizes.append(serving_config.max_batch_size)
        # the JAX engine's floor: the data-axis size
        self.batch_sizes = sorted({-(-b // mesh.world) * mesh.world for b in self.batch_sizes})
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=serving_config.queue_depth)
        self._inflight: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._last_command = time.perf_counter()
        self._dispatcher: Optional[threading.Thread] = None
        self._resolver: Optional[threading.Thread] = None
        self.queue_stats = LatencyStats()
        self.device_stats = LatencyStats()
        self.execute_stats = LatencyStats()
        self.fetch_stats = LatencyStats()
        self.total_stats = LatencyStats()
        # batch size -> (static frames, static cameras, its CUDA graph), filled by warmup
        self.graphs: Dict[int, Tuple[torch.Tensor, torch.Tensor, graphs.Graph]] = {}
        self.capture_mode = self._capture_mode()
        self.eager_batches = 0  # batches of a size without a graph, while the engine holds graphs
        self.capture_s: Optional[float] = None
        self.graph_pool_bytes: Optional[int] = None

    # -- public API ------------------------------------------------------------

    def start(self):
        if not self.leader:
            raise RuntimeError("only process 0 of the mesh starts the engine; the others follow()")
        self._dispatcher = threading.Thread(target=self._dispatch_loop, name="engine-dispatch", daemon=True)
        self._resolver = threading.Thread(target=self._resolve_loop, name="engine-resolve", daemon=True)
        self._resolver.start()
        self._dispatcher.start()
        return self

    def stop(self, timeout: float = 10.0):
        """Stop both threads (and a mesh's followers); raises if either is
        still alive after ``timeout``."""
        self._stop.set()
        for t in (self._dispatcher, self._resolver):
            if t is not None:
                t.join(timeout=timeout)
                if t.is_alive():
                    raise RuntimeError(f"engine thread {t.name} did not stop within {timeout} s")
        self._stop_followers()

    def follow(self) -> int:
        """A mesh process other than 0: serve process 0's batches until it
        stops; returns the number of batches served."""
        if self.leader:
            raise RuntimeError("process 0 of the mesh serves; follow() is for the others")
        h, w = self.frame_shape
        served = 0
        while True:
            command, b = self._command()
            if command == _STOP:
                return served
            if command == _BATCH:
                if b in self.graphs:
                    self._replay(b)
                else:
                    frames = torch.empty((b, h, w, 3), dtype=torch.uint8, device=self.device)
                    cams = torch.empty((b, 6), dtype=torch.float32, device=self.device)
                    self._batch(frames, cams)
                served += 1

    def _capture_mode(self) -> Optional[str]:
        """What ``warmup`` captures (module docstring): "batch" (a graph holds
        the whole batch, the mesh's collectives included), "rows" (a graph of
        this process's preprocess and predict, its collectives eager) or None
        (no graph: the CPU, and a gloo mesh with a space axis, whose predict
        makes collectives a graph cannot hold)."""
        if self.device.type != "cuda":
            return None
        if self.mesh.capturable:
            return "batch"
        return None if self.mesh.space > 1 else "rows"

    def warmup(self):
        """Before traffic, on every process of the mesh: capture one CUDA graph
        per batch size where ``capture_mode`` says so (module docstring), the
        processes in the same order; elsewhere process 0 runs every batch size
        once (cuDNN plans, lazy CUDA init), which reaches the followers
        through ``follow``."""
        h, w = self.frame_shape
        if self.capture_mode is not None:
            self._capture()
            return
        if not self.leader:
            return
        for b in self.batch_sizes:
            frames = np.zeros((b, h, w, 3), np.uint8)
            cams = np.tile(self._default_camera()[None], (b, 1))
            self._to_host(self._dispatch_device(frames, cams))

    def _capture(self):
        h, w = self.frame_shape
        t0 = time.perf_counter()
        pool = torch.cuda.graph_pool_handle()
        body = self._batch if self.capture_mode == "batch" else self._local
        for b in self.batch_sizes:
            frames = torch.zeros((b, h, w, 3), dtype=torch.uint8, device=self.device)
            cams = torch.from_numpy(np.tile(self._default_camera()[None], (b, 1))).to(self.device)
            graph = graphs.capture(lambda f=frames, c=cams: body(f, c), self.device, pool=pool)
            self.graphs[b] = (frames, cams, graph)
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.graph_pool_bytes = graphs.pool_bytes(pool, self.device)

    def submit(self, frame: np.ndarray, camera: Optional[np.ndarray] = None) -> Future:
        """Enqueue one RGB8 frame; resolves to (rotation_rad, translation_m) or None."""
        if camera is None:
            camera = self._default_camera()
        req = _Request(frame, camera)
        self._queue.put(req)
        return req.future

    def infer_blocking(self, frame: np.ndarray, camera: Optional[np.ndarray] = None,
                       timeout: Optional[float] = None):
        return self.submit(frame, camera).result(timeout=timeout)

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {
            "queue": self.queue_stats.summary(),
            "device": self.device_stats.summary(),
            "execute": self.execute_stats.summary(),
            "fetch": self.fetch_stats.summary(),
            "total": self.total_stats.summary(),
        }

    # -- internals -------------------------------------------------------------

    def _default_camera(self) -> np.ndarray:
        if self._default_camera_override is not None:
            return self._default_camera_override
        h, w = self.frame_shape
        scale = self.model_config.image_size / max(h, w)
        # desktop default intrinsics (480/480/128/128 at a 256 network input)
        return np.array([480.0, 480.0, w / 2, h / 2, 1000.0, scale], np.float32)

    def _command(self, command: int = 0, batch: int = 0):
        """Process 0's (command, batch size) on every process of the mesh."""
        header = torch.tensor([command, batch], dtype=torch.int64, device=self.device)
        self.mesh.broadcast_(header, "engine")
        self._last_command = time.perf_counter()
        return tuple(int(v) for v in header.tolist())

    def _stop_followers(self):
        if self.leader and self._followers:
            self._followers = False
            self._command(_STOP)

    def _batch(self, frames: torch.Tensor, cams: torch.Tensor):
        """Every process: process 0's frames and cameras broadcast in place
        into ``frames`` and ``cams``, then ``_predict``."""
        self.mesh.broadcast_(frames, "engine")
        self.mesh.broadcast_(cams, "engine")
        return self._predict(frames, cams)

    def _predict(self, frames: torch.Tensor, cams: torch.Tensor):
        """Every process: ``_local``, then the poses of every data row,
        all-gathered over ``data``: (num_valid, rotation, translation)."""
        return self._gathered(self._local(frames, cams))

    def _local(self, frames: torch.Tensor, cams: torch.Tensor) -> torch.Tensor:
        """Every process: its data rows, its slab of their rows, ``predict`` on
        the mesh; its rows' (num_valid, rotation, translation) packed (rows, 7)."""
        mesh, size = self.mesh, self.model_config.image_size
        rows = mesh.rows(frames.shape[0])
        with torch.inference_mode():
            images = preprocess_uint8_batch(frames[rows], size)[:, mesh.height_rows(size)]
            det = hmd_ego_pose.predict(
                self.model, images, cams[rows], self.model_config,
                score_threshold=self.cfg.score_threshold, iou_threshold=0.5,
                max_detections=1,  # streaming contract: best pose only
            )
            return torch.cat([det.num_valid[:, None].to(torch.float32), det.rotation[:, 0],
                              det.translation[:, 0]], dim=1)

    def _gathered(self, packed: torch.Tensor):
        """Every data row's packed poses, all-gathered over ``data`` into a new
        tensor, split into (num_valid, rotation, translation)."""
        with torch.inference_mode():
            packed = torch.cat(self.mesh.all_gather(packed, "engine", "data"))
        return packed[:, 0].to(torch.int64), packed[:, 1:4], packed[:, 4:7]

    def _replay(self, b: int):
        """Every process: batch size ``b``'s graph over its static buffers
        (process 0 filled them), with the broadcasts and the gather in it
        ("batch") or eager around it ("rows"); returns tensors the batch
        owns, since the next replay overwrites the graph's outputs."""
        frames, cams, graph = self.graphs[b]
        if self.capture_mode == "batch":
            graph.replay()
            return tuple(t.clone() for t in graph.outputs)
        self.mesh.broadcast_(frames, "engine")
        self.mesh.broadcast_(cams, "engine")
        graph.replay()
        return self._gathered(graph.outputs)

    def _dispatch_device(self, frames_u8: np.ndarray, cameras: np.ndarray):
        """Upload and enqueue the batch (broadcast to the followers); returns
        device tensors without waiting: the batch's own, also when its size's
        graph ran."""
        b = frames_u8.shape[0]
        held = self.graphs.get(b)
        if held is not None:
            frames, cams, _ = held
            with RECORDER.span("engine.upload"):
                frames.copy_(torch.from_numpy(frames_u8))
                cams.copy_(torch.from_numpy(np.ascontiguousarray(cameras, np.float32)))
            if self._followers:
                self._command(_BATCH, b)
            with RECORDER.span("engine.replay"):
                return self._replay(b)
        if self.graphs:
            self.eager_batches += 1
        if self._followers:
            self._command(_BATCH, b)
        with RECORDER.span("engine.upload"):
            frames = torch.from_numpy(frames_u8).to(self.device)
            cams = torch.from_numpy(np.ascontiguousarray(cameras, np.float32)).to(self.device)
        with RECORDER.span("engine.replay"):
            return self._batch(frames, cams)

    @staticmethod
    def _to_host(det):
        return tuple(t.cpu().numpy() for t in det)

    def _dispatch_loop(self):
        """Stage 1: batch formation, host packing, asynchronous dispatch."""
        h, w = self.frame_shape
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                if (self._followers and self.follower_error is None
                        and time.perf_counter() - self._last_command > HEARTBEAT_S):
                    try:
                        self._command(_IDLE)
                    except RuntimeError as exc:  # a follower is gone: the next batch fails its requests
                        self.follower_error = exc
                continue
            reqs = [first]
            while len(reqs) < self.cfg.max_batch_size:
                try:
                    reqs.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            t_start = time.perf_counter_ns()
            for r in reqs:
                self.queue_stats.record((t_start - r.t_enqueue) / 1e6)
                if r.trace is not None:
                    RECORDER.add("engine.queue", r.t_enqueue, t_start, *r.trace, thread="queue")
            try:
                b = next(s for s in self.batch_sizes if s >= len(reqs))
                bid, attrs = (RECORDER.next_id(), _batch_attrs(reqs, b)) if RECORDER.on else (0, None)
                with RECORDER.span("engine.batch", bid, 0, attrs):
                    with RECORDER.span("engine.pack"):
                        frames = np.zeros((b, h, w, 3), np.uint8)
                        cams = np.zeros((b, 6), np.float32)
                        for i, r in enumerate(reqs):
                            frames[i] = r.frame
                            cams[i] = r.camera
                        cams[len(reqs):] = reqs[0].camera  # pad rows with valid intrinsics
                    det = self._dispatch_device(frames, cams)
                    done = None
                    if self.device.type == "cuda":
                        done = torch.cuda.Event()
                        done.record()
            except Exception as exc:  # a failed batch fails its requests; serving goes on
                for r in reqs:
                    r.future.set_exception(exc)
                continue
            self._inflight.put((reqs, det, done, t_start, time.perf_counter_ns(), bid, attrs))
        while True:  # requests still queued at shutdown fail instead of hanging
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            r.future.set_exception(RuntimeError("engine stopped"))
        try:
            self._stop_followers()  # from the thread that issues the mesh's collectives
        except RuntimeError as exc:  # a follower is gone; the others fail on the group's timeout
            self.follower_error = exc
        self._inflight.put(None)  # the resolver exits on this sentinel

    def _resolve_loop(self):
        """Stage 2: wait for the device, copy the poses to the host, resolve futures."""
        while True:
            try:
                item = self._inflight.get(timeout=0.05)
            except queue.Empty:
                d = self._dispatcher
                if self._stop.is_set() and (d is None or not d.is_alive()):
                    return
                continue
            if item is None:
                return
            reqs, det, done, t_start, t_dispatched, bid, attrs = item
            try:
                t0 = time.perf_counter_ns()
                if done is not None:
                    done.synchronize()
                t1 = time.perf_counter_ns()
                num_valid, rotation, translation = self._to_host(det)
                t2 = time.perf_counter_ns()
                self.execute_stats.record((t1 - t_dispatched) / 1e6)
                self.fetch_stats.record((t2 - t1) / 1e6)
                RECORDER.add("engine.device_wait", t0, t1, bid, 0, attrs)
                RECORDER.add("engine.fetch", t1, t2, bid, 0, attrs)
            except Exception as exc:
                for r in reqs:
                    r.future.set_exception(exc)
                continue
            t_done = time.perf_counter_ns()
            self.device_stats.record((t_done - t_start) / 1e6)
            for i, r in enumerate(reqs):
                if int(num_valid[i]) > 0:
                    r.future.set_result((rotation[i] * math.pi, translation[i] / 1000.0))
                else:
                    r.future.set_result(None)
                self.total_stats.record((t_done - r.t_enqueue) / 1e6)
            RECORDER.add("engine.resolve", t_done, time.perf_counter_ns(), bid, 0, attrs)
