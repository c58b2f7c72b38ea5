"""The port's serving host path against the JAX package's, on the CPU.

* I420 and NV12 to RGB8 (``serving/frameio.py``): bit-equal to the JAX
  package's, the compiled C++ of each against the other's and the numpy
  fallbacks against each other, at sizes from 2x2 to 1080x1920; odd sizes
  raise.
* ``FrameRing``: the same answers as the JAX ring on one push/pop sequence,
  native and fallback, dropping the oldest frame at capacity.
* Frame messages of the three kinds byte-equal to the JAX package's.
* Cross-package loopback: a stub engine whose pose is a fixed function of
  the decoded RGB bytes behind both packages' ``PoseServer``; a JAX client
  served by the port and a port client served by JAX get the packets the
  other package's server gives.
* ``utils/profiler.py``: ``latency_histogram`` and ``StageTimer`` as the JAX
  package's, and ``profile_trace`` writing a Chrome trace on the CPU; the
  span recorder: off it records nothing, on it records nesting, parents,
  threads and shared ids.
"""

import glob
import hashlib
import json
import threading

import numpy as np
import pytest
import torch

import hmd_ego_pose_tpu.serving.frameio as jax_frameio
from hmd_ego_pose_tpu.serving import protocol as jax_protocol
from hmd_ego_pose_tpu.serving.server import PoseClient as JaxPoseClient
from hmd_ego_pose_tpu.serving.server import PoseServer as JaxPoseServer
from hmd_ego_pose_tpu.utils import profiler as jax_profiler
from hmd_ego_pose_tpu_torch.serving import frameio, protocol
from hmd_ego_pose_tpu_torch.serving.server import PoseClient, PoseServer
from hmd_ego_pose_tpu_torch.utils import profiler

SIZES = [(2, 2), (16, 16), (96, 96), (256, 256), (480, 640), (1080, 1920)]
CONVERT = {"i420": (frameio.i420_to_rgb, jax_frameio.i420_to_rgb),
           "nv12": (frameio.nv12_to_rgb, jax_frameio.nv12_to_rgb)}


def _numpy_paths(monkeypatch):
    """Both packages on their numpy path: as if no C++ library could be built."""
    monkeypatch.setattr(jax_frameio, "_lib", None)
    monkeypatch.setattr(jax_frameio, "_build_failed", True)
    monkeypatch.setattr(frameio, "_state", {"lib": None, "failed": True})


def _payload(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, size=h * w * 3 // 2, dtype=np.uint8)


@pytest.mark.parametrize("h,w", SIZES)
def test_yuv_conversion_bit_equal_to_jax_native_and_numpy(monkeypatch, h, w):
    assert frameio.library() is not None and jax_frameio.get_lib() is not None
    payloads = [_payload(h, w, seed) for seed in (h * w, h * w + 1)]
    frameio.CONVERSIONS.reset()
    native = {}
    for kind, (port, jax) in CONVERT.items():
        for i, p in enumerate(payloads):
            got = port(p, h, w)
            assert got.shape == (h, w, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, jax(p, h, w))
            native[kind, i] = got
    assert frameio.CONVERSIONS.snapshot() == {"native": 4}
    _numpy_paths(monkeypatch)
    frameio.CONVERSIONS.reset()
    for kind, (port, jax) in CONVERT.items():
        for i, p in enumerate(payloads):
            got = port(p, h, w)
            np.testing.assert_array_equal(got, jax(p, h, w))
            # the integer arithmetic is the same in C++ and numpy
            np.testing.assert_array_equal(got, native[kind, i])
    assert frameio.CONVERSIONS.snapshot() == {"numpy": 4}


def test_nv12_and_i420_of_the_same_planes_decode_alike():
    h, w = 32, 48
    rng = np.random.default_rng(4)
    y = rng.integers(0, 256, h * w, dtype=np.uint8)
    u, v = (rng.integers(0, 256, h * w // 4, dtype=np.uint8) for _ in range(2))
    uv = np.empty(h * w // 2, np.uint8)
    uv[0::2], uv[1::2] = u, v
    np.testing.assert_array_equal(frameio.nv12_to_rgb(np.concatenate([y, uv]), h, w),
                                  frameio.i420_to_rgb(np.concatenate([y, u, v]), h, w))
    # mid grey: (298 * (128 - 16) + 128) >> 8 = 130
    grey = np.full(h * w * 3 // 2, 128, np.uint8)
    assert (frameio.i420_to_rgb(grey, h, w) == 130).all()


@pytest.mark.parametrize("h,w", [(3, 4), (4, 3), (1, 1), (7, 9)])
def test_odd_sizes_raise(h, w):
    for kind in (protocol.KIND_I420, protocol.KIND_NV12):
        with pytest.raises(ValueError, match="even"):
            protocol.payload_size(kind, h, w)
        with pytest.raises(ValueError, match="even"):
            protocol.encode_raw_frame_message(b"\0" * (h * w * 3 // 2), kind, h, w)
        with pytest.raises(ValueError, match="even"):
            protocol.decode_frame_message(jax_protocol.encode_raw_frame_message(
                b"\0" * (h * w * 3 // 2), kind, h, w))
    for convert in (frameio.i420_to_rgb, frameio.nv12_to_rgb):
        with pytest.raises(ValueError, match="even"):
            convert(np.zeros(h * w * 3 // 2, np.uint8), h, w)
    assert protocol.payload_size(protocol.KIND_RGB8, h, w) == h * w * 3


def test_wrong_payload_sizes_and_kinds_raise():
    with pytest.raises(ValueError, match="uint8 bytes"):
        frameio.i420_to_rgb(np.zeros(23, np.uint8), 4, 4)
    with pytest.raises(ValueError, match="uint8 bytes"):
        frameio.nv12_to_rgb(np.zeros(24, np.int16), 4, 4)
    with pytest.raises(ValueError, match="unknown frame kind"):
        protocol.payload_size(3, 4, 4)
    with pytest.raises(ValueError, match="needs 24"):
        protocol.encode_raw_frame_message(b"\0" * 25, protocol.KIND_NV12, 4, 4)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_frame_ring_matches_jax(monkeypatch, path):
    if path == "numpy":
        _numpy_paths(monkeypatch)
    ring, jax_ring = frameio.FrameRing(12, capacity=4), jax_frameio.FrameRing(12, capacity=4)
    assert (ring._lib is not None) is (path == "native")
    assert (jax_ring._lib is not None) is (path == "native")
    rng = np.random.default_rng(7)
    script = [("push", 1), ("push", 1), ("pop", 1), ("push", 1), ("push", 1), ("push", 1), ("push", 1),
              ("push", 1), ("len", 0), ("pop", 3), ("pop", 10), ("pop", 2), ("push", 1), ("len", 0),
              ("pop", 0), ("pop", 5)]
    for op, n in script:
        if op == "push":
            frame = rng.integers(0, 256, size=(3, 4), dtype=np.uint8)
            assert ring.push(frame) == jax_ring.push(frame)
        elif op == "pop":
            got, want = ring.pop(n), jax_ring.pop(n)
            assert got.shape == want.shape and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
        else:
            assert len(ring) == len(jax_ring)
    # drop-oldest at capacity: six pushes into four slots keep the last four
    frames = [np.full(12, i, np.uint8) for i in range(6)]
    assert [ring.push(f) for f in frames] == [True] * 4 + [False] * 2
    np.testing.assert_array_equal(ring.pop(10)[:, 0], [2, 3, 4, 5])
    with pytest.raises(ValueError):
        ring.push(np.zeros(11, np.uint8))


def test_frame_messages_byte_equal_to_jax():
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, size=(6, 10, 3), dtype=np.uint8)
    yuv = rng.integers(0, 256, size=6 * 10 * 3 // 2, dtype=np.uint8).tobytes()
    assert protocol.encode_frame_message(rgb) == jax_protocol.encode_frame_message(rgb)
    assert protocol.encode_frame_message(rgb[:, ::2]) == jax_protocol.encode_frame_message(rgb[:, ::2])
    for kind in (protocol.KIND_RGB8, protocol.KIND_I420, protocol.KIND_NV12):
        assert kind == getattr(jax_protocol, {0: "KIND_RGB8", 1: "KIND_I420", 2: "KIND_NV12"}[kind])
        planes = np.frombuffer(yuv, np.uint8).reshape(9, 10)
        assert protocol.encode_frame_message(planes, kind) == jax_protocol.encode_frame_message(planes, kind)
        payload = rgb.tobytes() if kind == protocol.KIND_RGB8 else yuv
        msg = protocol.encode_raw_frame_message(payload, kind, 6, 10)
        assert msg == jax_protocol.encode_raw_frame_message(payload, kind, 6, 10)
        assert protocol.payload_size(kind, 6, 10) == jax_protocol.payload_size(kind, 6, 10)
        np.testing.assert_array_equal(protocol.decode_frame_message(msg), jax_protocol.decode_frame_message(msg))
    packet = protocol.encode_pose_packet(np.array([0.1, -0.2, 0.3]), np.array([0.01, 0.02, 0.6]))
    assert packet == jax_protocol.encode_pose_packet(np.array([0.1, -0.2, 0.3]), np.array([0.01, 0.02, 0.6]))
    assert protocol.no_detection_packet() == jax_protocol.no_detection_packet()


class StubEngine:
    """Both packages' servers call ``start``, ``infer_blocking`` and ``stop``;
    the pose is a fixed function of the decoded RGB bytes, None for a black frame."""

    def __init__(self):
        self.frames = []

    def start(self):
        return self

    def stop(self, timeout=None):
        pass

    def infer_blocking(self, frame, timeout=None):
        self.frames.append(frame.copy())
        if not frame.any():
            return None
        digest = np.frombuffer(hashlib.sha256(frame.tobytes()).digest()[:6], np.uint8).astype(np.float64)
        return digest[:3] / 255.0, np.array([frame.shape[0], frame.shape[1], frame.mean()]) / 1000.0


def _frames():
    rng = np.random.default_rng(5)
    rgb = [rng.integers(0, 256, size=(16, 24, 3), dtype=np.uint8) for _ in range(2)]
    yuv = [rng.integers(0, 256, size=16 * 24 * 3 // 2, dtype=np.uint8).tobytes() for _ in range(2)]
    black = bytes([16] * (16 * 24)) + bytes([128] * (16 * 24 // 2))  # Y=16, U=V=128 decodes to 0
    return ([(r.tobytes(), protocol.KIND_RGB8) for r in rgb]
            + [(p, kind) for p in yuv + [black] for kind in (protocol.KIND_I420, protocol.KIND_NV12)])


def _served(client, frames):
    out = []
    for payload, kind in frames:
        pose = client.infer_encoded(payload, kind, 16, 24)
        out.append(protocol.no_detection_packet() if pose is None else protocol.encode_pose_packet(*pose))
    return out


def test_cross_package_loopback_gives_the_same_packets():
    frames = _frames()
    engines = {"port": StubEngine(), "jax": StubEngine()}
    servers = {"port": PoseServer(engines["port"], port=0).start(),
               "jax": JaxPoseServer(engines["jax"], port=0).start()}
    try:
        packets = {}
        for client_pkg in ("port", "jax"):
            for server_pkg, server in servers.items():
                if client_pkg == "port":
                    with PoseClient(*server.address, timeout=30.0) as client:
                        packets[client_pkg, server_pkg] = _served(client, frames)
                else:
                    client = JaxPoseClient(*server.address)
                    client.sock.settimeout(30.0)
                    try:
                        packets[client_pkg, server_pkg] = _served(client, frames)
                    finally:
                        client.close()
    finally:
        servers["port"].stop(timeout=10.0)
        servers["jax"].stop()
    want = packets["jax", "jax"]
    assert len(want) == len(frames) and all(len(p) == 24 for p in want)
    assert want[-1] == want[-2] == protocol.no_detection_packet()
    assert len(set(want[:-2])) == len(frames) - 2
    for key, got in packets.items():
        assert got == want, key
    # each server decoded every frame to the same RGB as the other
    for a, b in zip(engines["port"].frames, engines["jax"].frames):
        np.testing.assert_array_equal(a, b)
    assert not any(t.name == "pose-server" and t.is_alive() for t in threading.enumerate())


def test_latency_histogram_and_stage_timer_match_jax():
    samples = list(np.random.default_rng(3).gamma(2.0, 20.0, size=257))
    for bins in (20, 7):
        assert profiler.latency_histogram(samples, bins) == jax_profiler.latency_histogram(samples, bins)
    assert profiler.latency_histogram([]) == jax_profiler.latency_histogram([]) == {"count": 0}
    timer, jax_timer = profiler.StageTimer(), jax_profiler.StageTimer()
    for t in (timer, jax_timer):
        for name in ("decode", "infer", "decode"):
            with t.stage(name):
                pass
    report, jax_report = timer.report(), jax_timer.report()
    assert list(report) == list(jax_report) == ["decode", "infer"]
    for name in report:
        assert set(report[name]) == set(jax_report[name])
        assert report[name]["count"] == jax_report[name]["count"]


def test_profile_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    with profiler.profile_trace(str(tmp_path / "prof")) as prof:
        y = (x @ x).relu().sum()
    assert float(y) > 0
    assert glob.glob(str(tmp_path / "prof" / "*.json")) == [prof.trace_path]
    with open(prof.trace_path) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert any("mm" in e.key for e in prof.key_averages())


@pytest.mark.parametrize("use", ["span", "stage", "add", "next_id", "current"])
def test_span_recorder_off_records_nothing(use):
    rec = profiler.StageTimer()
    assert not rec.on
    if use == "span":
        with rec.span("a", 7, 3, {"batch": 1}) as opened:
            assert opened is None
            with rec.span("b") as inner:
                assert inner is None
        assert rec.span("a") is rec.span("b")  # one shared no-op context
    elif use == "stage":
        with rec.stage("decode"):
            pass
        assert rec.samples["decode"] and len(rec.samples["decode"]) == 1
    elif use == "add":
        rec.add("engine.queue", 1, 2, 3, 4, thread="queue")
    elif use == "next_id":
        assert rec.next_id() == 0
    else:
        with rec.span("a"):
            assert rec.current() is None
    assert rec.stop() == []
    rec.start()
    assert rec.stop() == []  # nothing recorded while off reaches a later recording


def test_span_recorder_records_nesting_parents_threads_and_shared_ids():
    rec = profiler.StageTimer()
    rec.start()
    rid = rec.next_id()
    assert rid > 0
    with rec.span("outer", rid, 0, {"batch": 2, "rows": 1}) as outer:
        assert rec.current() == (rid, outer)
        with rec.span("inner") as inner:
            assert rec.current() == (rid, inner)
            with rec.span("own", rec.next_id()) as own:
                pass
        with rec.stage("staged"):
            pass
    seen = {}

    def worker(ctx):  # another thread's span under the handed-over one
        with rec.span("remote", *ctx) as sid:
            seen["sid"] = sid

    t = threading.Thread(target=worker, args=((rid, outer),), name="worker-1")
    t.start()
    t.join()
    rec.add("queued", 5, 9, rid, inner, thread="queue")
    spans = rec.stop()
    assert not rec.on
    with rec.span("after"):
        pass
    assert rec.stop() == []
    by = {s.name: s for s in spans}
    assert set(by) == {"outer", "inner", "own", "staged", "remote", "queued"}
    assert [s.name for s in spans][:3] == ["queued", "outer", "inner"]  # by start time
    o, i = by["outer"], by["inner"]
    assert (o.span_id, o.parent, o.rid, o.attrs, o.thread) == (outer, 0, rid, {"batch": 2, "rows": 1}, "MainThread")
    assert (i.span_id, i.parent, i.rid, i.attrs) == (inner, outer, rid, o.attrs)  # inherits id and attributes
    assert by["own"].parent == inner and by["own"].rid not in (0, rid) and by["own"].attrs is None
    assert (by["staged"].parent, by["staged"].rid) == (outer, rid)
    assert rec.samples["staged"] and len(rec.samples["staged"]) == 1
    r = by["remote"]
    assert (r.span_id, r.parent, r.rid, r.thread) == (seen["sid"], outer, rid, "worker-1")
    q = by["queued"]
    assert (q.start_ns, q.end_ns, q.rid, q.parent, q.thread) == (5, 9, rid, inner, "queue")
    assert o.start_ns <= i.start_ns <= by["own"].start_ns <= by["own"].end_ns <= i.end_ns <= o.end_ns
    assert len({s.span_id for s in spans}) == len(spans)
