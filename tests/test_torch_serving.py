"""The port's serving slice end to end on the CPU, and the port's own rules.

* Golden acceptance: both shipped int8 artifacts restored by the port,
  ``predict`` in bf16 on the six committed frames each, held to the JAX
  package's goldens within the bounds of ``hmd_ego_pose_tpu_torch/eval/golden.py``.
* A loopback ``PoseServer`` round trip on port 0, every wait bounded.
* The server's and the engine's spans (``utils/profiler.py::RECORDER``):
  every frame of two clients followed by its id from the handler through
  the engine's queue to the batch that carried it.
* No module of the port, and not ``chip_smoke.py``, imports jax, the JAX
  package, PIL or yaml (read from the sources' syntax trees).
* The port's PNG reader against PIL.
"""

import ast
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.config import ModelConfig
from hmd_ego_pose_tpu_torch.data.image import read_png
from hmd_ego_pose_tpu_torch.eval import golden as hold
from hmd_ego_pose_tpu_torch.models import hmd_ego_pose
from hmd_ego_pose_tpu_torch.ops.preprocess import preprocess_uint8_batch
from hmd_ego_pose_tpu_torch.serving import frameio, protocol
from hmd_ego_pose_tpu_torch.serving.server import PoseClient, PoseServer
from hmd_ego_pose_tpu_torch.train.checkpoint import load_model
from hmd_ego_pose_tpu_torch.utils.device import resolve_device
from hmd_ego_pose_tpu_torch.utils.profiler import RECORDER

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens")
CASES = {  # golden prefix -> (artifact, hand_relative)
    "handrel": ("syn1000_phi0_576ep_handrel_int8", True),
    "trained": ("syn1000_phi0_448ep_int8", False),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _golden(prefix):
    golden = dict(np.load(os.path.join(GOLDEN, f"{prefix}_ckpt_expected.npz")).items())
    n = int(golden["n_frames"])
    frames = np.stack([read_png(os.path.join(GOLDEN, f"{prefix}_ckpt_frame_{i}.png")) for i in range(n)])
    cameras = np.concatenate([golden[f"camera_{i}"] for i in range(n)]).astype(np.float32)
    return golden, frames, cameras


@pytest.mark.parametrize("prefix", sorted(CASES))
def test_golden_acceptance_on_cpu(prefix):
    name, hand_relative = CASES[prefix]
    golden, frames, cameras = _golden(prefix)
    cfg = ModelConfig(phi=0, image_size=256, compute_dtype="bfloat16", hand_relative=hand_relative)
    model, meta = load_model(os.path.join(REPO, "trained", name + ".npz"), cfg, device="cpu")
    assert cli.resolve_hand_relative(False, meta) is hand_relative
    cams = torch.from_numpy(cameras)
    outputs = hmd_ego_pose.apply(model, preprocess_uint8_batch(torch.from_numpy(frames), 256), cfg)
    dets = hmd_ego_pose.detect(outputs, cams, cfg, score_threshold=0.1)
    reports = [hold.hold_frame(hold.top_detection(dets, i), hold.tied_candidates(outputs, cams, i, cfg),
                               golden, i, hand_relative) for i in range(len(frames))]
    assert all(r["ok"] for r in reports), reports
    # most frames meet the unwidened tolerances on the top detection itself
    plain = [r for r in reports if not r["tie_switch"]
             and all(r["dev"][k] <= hold.TOLERANCES[k] for k in hold.QUANTITIES)]
    assert len(plain) >= 4, reports


def test_bf16_step_and_bounds():
    assert hold.bf16_step(0.5) == 2.0 ** -8
    assert hold.bf16_step(0.4999) == 2.0 ** -9
    golden = {"translation_0": np.array([1.0, 2.0, 600.0])}
    b = hold.bounds(golden, 0, hand_relative=True)
    assert b["translation"] == pytest.approx(2.0 + 3.90625)
    assert b["hand"] == pytest.approx(5e-3 + 3.90625e-3)
    assert hold.bounds(golden, 0, hand_relative=False)["hand"] == 5e-3


def test_tie_switch_needs_the_golden_and_the_prediction_among_tied_anchors():
    golden = {"translation_0": np.array([0.0, 0.0, 600.0]), "rotation_0": np.zeros(3)}
    q = ("rotation", "translation")
    near = {"rotation": np.zeros(3), "translation": np.array([0.0, 0.0, 601.0])}
    far = {"rotation": np.zeros(3), "translation": np.array([0.0, 0.0, 620.0])}
    assert hold.hold_frame(near, [], golden, 0, False, q) == {
        "frame": 0, "dev": {"rotation": 0.0, "translation": 1.0}, "ok": True, "tie_switch": False}
    # the prediction is a tied anchor, and another tied anchor matches the golden
    report = hold.hold_frame(far, [far, near], golden, 0, False, q)
    assert report["ok"] and report["tie_switch"]
    # no tied anchor matches the golden, or the prediction is none of them: fail
    assert not hold.hold_frame(far, [far], golden, 0, False, q)["ok"]
    assert not hold.hold_frame(far, [near], golden, 0, False, q)["ok"]


def test_loopback_pose_server_round_trip():
    golden, frames, _ = _golden("handrel")
    engine = cli.build_engine(os.path.join(REPO, "trained", CASES["handrel"][0] + ".npz"), "cpu",
                              frame_size=256, max_batch_size=2, score_threshold=0.1)
    assert engine.batch_sizes == [1, 2]
    server = PoseServer(engine, host="127.0.0.1", port=0).start()
    try:
        host, port = server.address
        assert port != 0
        with PoseClient(host, port, timeout=60.0) as client:
            for i in (0, 3):
                rotation, translation = client.infer(frames[i])
                bnd = hold.bounds(golden, i, hand_relative=True)
                np.testing.assert_allclose(rotation, golden[f"rotation_{i}"], atol=bnd["rotation"])
                np.testing.assert_allclose(translation, golden[f"translation_{i}"] / 1000.0,
                                           atol=bnd["translation"] / 1000.0)
            # no detection clears the threshold on a black frame: 24 bytes of NaN
            assert client.infer(np.zeros_like(frames[0])) is None
        stats = engine.stats()
        assert set(stats) == {"queue", "device", "execute", "fetch", "total"}
        assert stats["total"]["count"] == 3
    finally:
        server.stop(timeout=10.0)
    assert not any(t.name in ("pose-server", "engine-dispatch", "engine-resolve") and t.is_alive()
                   for t in threading.enumerate())


def test_concurrent_clients_get_their_own_poses():
    """Requests of several clients batch together; each answer reaches its own client."""
    import sys

    golden, frames, _ = _golden("handrel")
    engine = cli.build_engine(os.path.join(REPO, "trained", CASES["handrel"][0] + ".npz"), "cpu",
                              frame_size=256, max_batch_size=4, score_threshold=0.1)
    server = PoseServer(engine, host="127.0.0.1", port=0).start()
    errors, done = [], []
    switch = sys.getswitchinterval()

    def client(frame_ids):
        try:
            with PoseClient(*server.address, timeout=60.0) as c:
                for i in frame_ids:
                    rotation, translation = c.infer(frames[i])
                    bnd = hold.bounds(golden, i, hand_relative=True)
                    np.testing.assert_allclose(rotation, golden[f"rotation_{i}"], atol=bnd["rotation"])
                    np.testing.assert_allclose(translation, golden[f"translation_{i}"] / 1000.0,
                                               atol=bnd["translation"] / 1000.0)
                    done.append(i)
        except Exception as exc:  # collected and re-raised on the main thread
            errors.append(exc)

    try:
        sys.setswitchinterval(1e-5)
        threads = [threading.Thread(target=client, args=([k, (k + 3) % 6],)) for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        server.stop(timeout=10.0)
    assert not errors, errors
    assert sorted(done) == sorted(list(range(6)) * 2)
    assert engine.stats()["total"]["count"] == 12


def test_spans_follow_each_frame_from_the_handler_to_its_batch():
    """Two clients, three frames each, the recorder on: every frame's four
    handler spans and its queue wait under one id, the wait the parent of
    the engine's spans of the frame; every batch span names its frames; the
    queue spans are the samples of ``stats()["queue"]``."""
    _, frames, _ = _golden("handrel")
    engine = cli.build_engine(os.path.join(REPO, "trained", CASES["handrel"][0] + ".npz"), "cpu",
                              frame_size=256, max_batch_size=2, score_threshold=0.1)
    older = set(threading.enumerate())
    server = PoseServer(engine, host="127.0.0.1", port=0).start()
    errors = []

    def client(ids):
        try:
            with PoseClient(*server.address, timeout=60.0) as c:
                for i in ids:
                    c.infer(frames[i])
        except Exception as exc:  # collected and re-raised on the main thread
            errors.append(exc)

    RECORDER.start()
    try:
        threads = [threading.Thread(target=client, args=(ids,)) for ids in ([0, 1, 2], [3, 4, 5])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        # a client returns once its last packet arrives, which can be before
        # the handler's thread closes that frame's server.send span: wait for
        # the connections' threads to end (the clients closed their sockets)
        for conn in [t for t in threading.enumerate() if t not in older and t.name.startswith("pose-conn-")]:
            conn.join(timeout=30)
            assert not conn.is_alive(), conn.name
    finally:
        spans = RECORDER.stop()
        server.stop(timeout=10.0)
    assert not errors, errors
    handler = ("server.recv", "server.decode", "server.wait", "server.send")
    rids = sorted({s.rid for s in spans if s.name == "server.recv"})
    assert len(rids) == 6 and 0 not in rids
    threads_of = set()
    for rid in rids:
        mine = {s.name: s for s in spans if s.rid == rid}
        assert set(mine) == set(handler) | {"engine.queue"}, rid
        threads_of.add(mine["server.recv"].thread)
        assert {mine[n].thread for n in handler} == {mine["server.recv"].thread}
        assert all(mine[a].end_ns <= mine[b].start_ns for a, b in zip(handler[:-1], handler[1:]))
        queue = mine["engine.queue"]
        assert (queue.thread, queue.parent) == ("queue", mine["server.wait"].span_id)
        assert mine["server.wait"].start_ns <= queue.start_ns <= queue.end_ns <= mine["server.wait"].end_ns
    assert sorted(threads_of) == ["pose-conn-1", "pose-conn-2"]
    batches = [s for s in spans if s.name == "engine.batch"]
    carried = sorted(f for b in batches for f in b.attrs["frames"])
    assert carried == rids
    for b in batches:
        a = b.attrs
        assert a["rows"] == len(a["frames"]) and a["batch"] in (1, 2) and a["batch"] >= a["rows"]
        mine = {s.name: s for s in spans if s.rid == b.rid}
        assert set(mine) == {"engine.batch", "engine.pack", "engine.upload", "engine.replay",
                             "engine.device_wait", "engine.fetch", "engine.resolve"}
        assert all(s.attrs is a for s in mine.values())
        assert {mine[n].parent for n in ("engine.pack", "engine.upload", "engine.replay")} == {b.span_id}
        assert {mine[n].thread for n in ("engine.pack", "engine.upload", "engine.replay")} == {"engine-dispatch"}
        assert {mine[n].thread for n in ("engine.device_wait", "engine.fetch", "engine.resolve")} == {"engine-resolve"}
    waits = sorted((s.end_ns - s.start_ns) / 1e6 for s in spans if s.name == "engine.queue")
    assert waits == sorted(engine.queue_stats.samples)


def test_protocol_round_trip_and_rgb8_only():
    """Named for the RGB8-only refusal it pinned until the port decoded I420 and
    NV12; it now holds the round trip of all three kinds."""
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, size=(4, 6, 3), dtype=np.uint8)
    np.testing.assert_array_equal(protocol.decode_frame_message(protocol.encode_frame_message(frame)), frame)
    planes = rng.integers(0, 256, size=4 * 6 * 3 // 2, dtype=np.uint8)
    for kind, convert in ((protocol.KIND_I420, frameio.i420_to_rgb), (protocol.KIND_NV12, frameio.nv12_to_rgb)):
        assert protocol.payload_size(kind, 4, 6) == 36
        message = protocol.encode_raw_frame_message(planes.tobytes(), kind, 4, 6)
        assert protocol.decode_frame_header(message[:protocol.HEADER_BYTES]) == (kind, 4, 6)
        decoded = protocol.decode_frame_message(message)
        assert decoded.shape == (4, 6, 3) and decoded.dtype == np.uint8
        np.testing.assert_array_equal(decoded, convert(planes, 4, 6))
    packet = protocol.encode_pose_packet(np.array([0.1, 0.2, 0.3]), np.array([1.0, 2.0, 3.0]))
    assert len(packet) == protocol.POSE_PACKET_BYTES == 24
    rotation, translation = protocol.decode_pose_packet(packet)
    np.testing.assert_allclose(np.concatenate([rotation, translation]), [0.1, 0.2, 0.3, 1, 2, 3], rtol=1e-6)
    with pytest.raises(ValueError):
        protocol.payload_size(3, 4, 6)  # no fourth kind
    with pytest.raises(ValueError):
        protocol.decode_frame_message(protocol.encode_frame_message(frame)[:-1])  # a short payload


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        cli.build_engine(None, None)
    assert resolve_device("cpu").type == "cpu"


def test_hand_relative_flag_contradiction_is_an_error():
    assert cli.resolve_hand_relative(False, {"hand_relative": True}) is True
    assert cli.resolve_hand_relative(True, {}) is True
    with pytest.raises(SystemExit):
        cli.resolve_hand_relative(True, {"hand_relative": False})
    args = cli.build_parser().parse_args(["serve", "--ckpt", "x.npz", "--device", "cpu", "--port", "0"])
    assert (args.ckpt, args.device, args.port, args.frame_size) == ("x.npz", "cpu", 0, 480)


def _sources():
    root = os.path.join(REPO, "hmd_ego_pose_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax_pil_or_yaml():
    banned = ("jax", "jaxlib", "hmd_ego_pose_tpu", "PIL", "yaml", "matplotlib")
    offenders = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    offenders.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {name}")
    assert len(list(_sources())) > 20
    assert {"pt2.py", "reference.py"} <= {os.path.basename(p) for p in _sources() if os.sep + "export" + os.sep in p}
    assert {"visualization.py", "samplevis.py"} <= {os.path.basename(p) for p in _sources()}
    assert not offenders, offenders


@pytest.mark.parametrize("prefix", sorted(CASES))
def test_png_reader_matches_pil(prefix):
    for i in range(6):
        path = os.path.join(GOLDEN, f"{prefix}_ckpt_frame_{i}.png")
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(read_png(path), want)


def test_png_reader_all_filters_and_rgba(tmp_path):
    rng = np.random.default_rng(0)
    rgba = rng.integers(0, 256, size=(9, 11, 4), dtype=np.uint8)
    rgba[:, :, 0] = np.arange(11, dtype=np.uint8) * 20  # smooth rows make the encoder pick other filters
    path = str(tmp_path / "x.png")
    Image.fromarray(rgba, "RGBA").save(path, optimize=True)
    np.testing.assert_array_equal(read_png(path), rgba[..., :3])
    # 8-bit gray (the synthetic masks) reads as gray replicated to RGB, as PIL converts it
    Image.fromarray(rgba, "RGBA").convert("L").save(path, optimize=True)
    with Image.open(path) as im:
        np.testing.assert_array_equal(read_png(path), np.asarray(im.convert("RGB")))
    Image.fromarray(rgba, "RGBA").convert("P").save(path)  # palette: outside the supported formats
    with pytest.raises(ValueError):
        read_png(path)
