"""Serving cells: HoloLens clients streaming I420 frames to ``PoseServer``.

Set-up restores the configuration's weights through the program's int8
path, builds the bf16 model and ``InferenceEngine`` for the clients' frame
size (its warm-up captures a CUDA graph per batch size), starts
``PoseServer`` on port 0, and starts the clients in a process of their own
(``harness/loadgen.py``), which renders the frame pool from the seed
meanwhile.  A warm-up phase of the same traffic runs every path once (the
frame-ingest library builds, every batch size replays).  Then the window:
every client sends its frames when due for ``seconds``; the run waits for
each answer, up to ``grace_seconds`` past the close.

A traced run times ``profile_seconds`` of the window's middle on the
device, with CUDA events around each batch the engine uploads and enqueues
(``harness/trace.py::BatchTimeline``); the rates and tails are still taken
over the whole window.

``correct``: every frame sent in the window answered (a client that sheds
load skips frames, which ask for no answer and are counted), and a sample
of the answers (drawn from the seed) within the limits of the reference
(``reference/serve_check.py``), which runs once the window has closed, the
peak memory read and the program's state freed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from harness import common
from harness.arith import percentile

LOADGEN = os.path.join(common.BENCH, "harness", "loadgen.py")


class _LoadGen:
    """The client process: JSON lines in, JSON lines out."""

    def __init__(self, spec: Dict):
        self.proc = subprocess.Popen([sys.executable, LOADGEN], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     text=True, cwd=common.BENCH)
        self.send(spec)

    def send(self, obj: Dict) -> None:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def receive(self) -> Dict:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the client process ended (exit code {self.proc.poll()})")
        return json.loads(line)

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.send({"cmd": "quit"})
            except (BrokenPipeError, OSError):
                pass
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)


def client_spec(traffic: Dict, seed: int, clients: Optional[int] = None) -> Dict:
    """The client process's parameters: the traffic's, for ``clients`` headsets."""
    keys = ("fps", "pool", "frame_height", "frame_width", "focal_scale", "clock_spread", "max_outstanding")
    return dict({k: traffic[k] for k in keys if k in traffic}, seed=seed, clients=clients or traffic["clients"])


def camera(conf: Dict, traffic: Dict) -> np.ndarray:
    """[fx, fy, px, py, tz scale, image scale] of the clients' camera."""
    h, w = traffic["frame_height"], traffic["frame_width"]
    f = 480.0 * traffic["focal_scale"]
    return np.array([f, f, w / 2, h / 2, 1000.0, conf["image_size"] / max(h, w)], np.float32)


def build_server(conf: Dict, traffic: Dict, device, fault: Optional[str] = None):
    """The program's serving path for this configuration: restore, bf16
    model, engine (warm-up captures its graphs), server on port 0."""
    import torch

    from hmd_ego_pose_tpu_torch.config import ModelConfig, ServingConfig
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
    from hmd_ego_pose_tpu_torch.models.weights import from_jax_params
    from hmd_ego_pose_tpu_torch.serving.engine import InferenceEngine
    from hmd_ego_pose_tpu_torch.serving.server import PoseServer
    from hmd_ego_pose_tpu_torch.train.checkpoint import meta_hand_relative, restore_checkpoint

    sv = conf["serving"]
    params, bn_state, meta = restore_checkpoint(os.path.join(common.ROOT, sv["weights"]), device)
    recorded = meta_hand_relative(meta)
    mcfg = ModelConfig(phi=conf["phi"], image_size=conf["image_size"], compute_dtype=sv["compute_dtype"],
                       hand_relative=sv["hand_relative"] if recorded is None else recorded)
    model = HMDEgoPose(mcfg).to(device).eval()
    model.load_state_dict(from_jax_params(params, bn_state, mcfg), strict=True)
    del params, bn_state
    engine = InferenceEngine(model, mcfg, ServingConfig(max_batch_size=sv["max_batch_size"],
                                                        score_threshold=sv["score_threshold"]),
                             frame_shape=(traffic["frame_height"], traffic["frame_width"]),
                             default_camera=camera(conf, traffic), device=device)
    produce = engine._to_host
    if fault == "alter":  # a test's fault: every translation moved where the engine produces it
        engine._to_host = lambda det: tuple(a + 50.0 if i == 2 else a for i, a in enumerate(produce(det)))
    elif fault == "empty":  # a test's fault: every answer says "no detection" where it is produced
        engine._to_host = lambda det: tuple(np.zeros_like(a) if i == 0 else a for i, a in enumerate(produce(det)))
    engine.warmup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return engine, PoseServer(engine, host="127.0.0.1", port=0).start()


def _window_frames(reply: Dict) -> List[List]:
    return [rec + [c] for c, recs in enumerate(reply["clients"]) for rec in (recs or [])]


def run(cell: Dict, seed: int, seconds: int, trace: bool, device=None, fault: Optional[str] = None) -> Dict:
    import torch

    from harness import trace as tracing
    from hmd_ego_pose_tpu_torch.serving.engine import LatencyStats
    from reference.model import Widths

    conf, traffic = cell["config"], cell["traffic"]
    device = torch.device(device or "cuda")
    gen = _LoadGen(client_spec(traffic, seed))
    server = None
    try:
        engine, server = build_server(conf, traffic, device, fault)
        timeline = tracing.BatchTimeline(lambda frames, cameras: f"engine batch of {frames.shape[0]}")
        if device.type == "cuda":
            engine._dispatch_device = timeline.wrap(engine._dispatch_device)
        port = server.address[1]
        if "ready" not in gen.receive():
            raise RuntimeError("the client process did not render its frames")
        warm = traffic["warm_seconds"]
        gen.send({"cmd": "run", "port": port, "start": time.monotonic() + 0.1, "seconds": warm,
                  "grace": traffic["grace_seconds"], "salt": 0})
        warm_frames = _window_frames(gen.receive())
        if any(r[3] is None for r in warm_frames):
            raise RuntimeError("a warm-up frame was not answered")
        for name in ("queue_stats", "total_stats", "device_stats", "execute_stats", "fetch_stats"):
            setattr(engine, name, LatencyStats())
        eager0 = engine.eager_batches
        start = time.monotonic() + 0.2
        setup_s = common.process_age_s() + (start - time.monotonic())
        gen.send({"cmd": "run", "port": port, "start": start, "seconds": seconds,
                  "grace": traffic["grace_seconds"], "salt": 1})
        prof, slice_frames = None, None
        if trace:
            time.sleep(max(0.0, start + (seconds - traffic["profile_seconds"]) / 2 - time.monotonic()))
            with timeline.recorded():
                n0 = engine.total_stats.count
                time.sleep(traffic["profile_seconds"])
                slice_frames = engine.total_stats.count - n0
            prof = timeline.trace()
        reply = gen.receive()
        frames, skipped = _window_frames(reply), reply["skipped"]
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        engine_view = {"queue_p50_ms": engine.queue_stats.percentile(50),
                       "total_p50_ms": engine.total_stats.percentile(50),
                       "eager_batches": engine.eager_batches - eager0,
                       "stats_p50_ms": {k: v["p50_ms"] for k, v in engine.stats().items()},
                       "batches": engine.device_stats.count}
    finally:
        if server is not None:
            server.stop()
        gen.close()
    del engine, server
    if device.type == "cuda":
        torch.cuda.empty_cache()

    lat = [float("inf") if r[3] is None else (r[3] - r[1]) * 1000.0 for r in frames]
    late = [(r[2] - r[1]) * 1000.0 for r in frames if r[2] is not None]
    answered = sum(1 for r in frames if r[3] is not None)
    in_window = sum(1 for r in frames if r[3] is not None and r[3] <= seconds)
    e2e = {"serve_p50_ms": percentile(lat, 50), "serve_p95_ms": percentile(lat, 95),
           "serve_fps": in_window / seconds, "setup_s": setup_s}
    checks, correct, gaps = check(conf, traffic, seed, frames, device)
    if answered < len(frames):
        correct = False
    ctx = {"client_p50_ms": e2e["serve_p50_ms"], "client_p95_ms": e2e["serve_p95_ms"], "engine": engine_view,
           "trace": prof, "slice_frames": slice_frames, "widths": Widths.of(conf),
           "image_size": conf["image_size"]}
    return {"e2e": e2e, "ctx": ctx, "correct": correct, "attempted": len(frames), "failed": len(frames) - answered,
            "peak": peak, "trace": prof, "checks": checks,
            "extra": {"generator_late_ms": {"p50": percentile(late, 50), "max": max(late) if late else None},
                      "answered_after_close": answered - in_window, "skipped_frames": skipped,
                      "engine": engine_view, "gaps": gaps}}


def check(conf: Dict, traffic: Dict, seed: int, frames: List[List], device):
    """The sample's gaps to the reference, each beside its limit."""
    from harness.loadgen import rgb_to_i420
    from harness.synthetic import serving_frame
    from reference import serve_check
    from reference.model import Widths, load_artifact

    answered = [r for r in frames if r[3] is not None]
    rng = np.random.RandomState([seed % (2 ** 32), 0xC4EC])
    n = min(traffic["check_frames"], len(answered))
    sample = [answered[i] for i in sorted(rng.choice(len(answered), n, replace=False))] if n else []
    h, w = traffic["frame_height"], traffic["frame_width"]
    payloads, cache = [], {}
    for r in sample:
        if r[0] not in cache:
            cache[r[0]] = rgb_to_i420(serving_frame(seed, r[0], h, w, traffic["focal_scale"]))
        payloads.append(cache[r[0]])
    P, S = load_artifact(os.path.join(common.ROOT, conf["serving"]["weights"]))
    cands = serve_check.candidates(Widths.of(conf), P, S, payloads, h, w, camera(conf, traffic), conf["image_size"],
                                   device)
    answers = []
    for r in sample:
        pose = r[4]
        if pose is None or any(v is None for v in pose):
            answers.append(None)
        else:
            answers.append((np.array(pose[:3]), np.array(pose[3:])))
    worst = serve_check.judge(answers, cands)
    limits = common.load_json(os.path.join(common.BENCH, "reference", "limits", conf["name"] + ".json"))["serve"]
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in sorted(limits)}
    checks["sampled_frames"] = {"value": n, "limit": traffic["check_frames"]}
    correct = n == traffic["check_frames"] and all(worst[k] <= limits[k] for k in limits)
    return checks, correct, worst


def sweep(cell: Dict, counts: List[int], seed: int, seconds: int, device=None) -> List[Dict]:
    """One server, then each headset count in turn for ``seconds``: offered
    and answered rates, round-trip p50 and p95, and the backlog (frames still
    unanswered at the close).  What the cells' client counts were set from."""
    import torch

    conf, traffic = cell["config"], cell["traffic"]
    device = torch.device(device or "cuda")
    engine, server = build_server(conf, traffic, device)
    rows = []
    try:
        for n in counts:
            gen = _LoadGen(client_spec(traffic, seed, n))
            try:
                gen.receive()
                port = server.address[1]
                gen.send({"cmd": "run", "port": port, "start": time.monotonic() + 0.1, "seconds": 2,
                          "grace": traffic["grace_seconds"], "salt": 0})
                gen.receive()
                gen.send({"cmd": "run", "port": port, "start": time.monotonic() + 0.2, "seconds": seconds,
                          "grace": traffic["grace_seconds"], "salt": 1})
                reply = gen.receive()
                frames = _window_frames(reply)
            finally:
                gen.close()
            lat = [float("inf") if r[3] is None else (r[3] - r[1]) * 1000.0 for r in frames]
            tail = [x for r, x in zip(frames, lat) if r[1] >= seconds - 1.0]
            rows.append({"headsets": n, "offered_fps": len(frames) / seconds,
                         "answered_fps": sum(1 for r in frames if r[3] is not None and r[3] <= seconds) / seconds,
                         "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
                         "last_second_p50_ms": percentile(tail, 50),
                         "backlog_at_close": sum(1 for r in frames if r[3] is None or r[3] > seconds),
                         "unanswered": sum(1 for r in frames if r[3] is None), "skipped": reply["skipped"]})
            print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    finally:
        server.stop()
    return rows
