"""One seed makes the same inputs twice: frames, bytes, schedules, splits."""

import hashlib
import os

import numpy as np
import pytest

from harness import loadgen, synthetic
from reference.model import i420_to_rgb


def _digest(root):
    h = hashlib.sha256()
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            h.update(f.encode())
            h.update(open(os.path.join(dirpath, f), "rb").read())
    return h.hexdigest()


def test_a_seed_gives_the_same_serving_frame_and_bytes():
    big = 2 ** 31 + 12345
    a = loadgen.rgb_to_i420(synthetic.serving_frame(big, 3, 64, 112, 0.5))
    b = loadgen.rgb_to_i420(synthetic.serving_frame(big, 3, 64, 112, 0.5))
    assert a == b and len(a) == 64 * 112 * 3 // 2
    assert a != loadgen.rgb_to_i420(synthetic.serving_frame(big + 1, 3, 64, 112, 0.5))
    assert a != loadgen.rgb_to_i420(synthetic.serving_frame(big, 4, 64, 112, 0.5))


def test_a_seed_gives_the_same_send_schedule():
    a = loadgen.schedule(2 ** 31 + 7, 5, 30.0, 64, 2.0, 1, 0.0025)
    assert a == loadgen.schedule(2 ** 31 + 7, 5, 30.0, 64, 2.0, 1, 0.0025)
    b = loadgen.schedule(2 ** 31 + 8, 5, 30.0, 64, 2.0, 1, 0.0025)
    assert a != b
    assert all(0 <= c["phase"] < 1 / 30.0 for c in a)
    for s in (a, b):  # every seed: the same set of clock rates, dealt in another order
        assert sorted(c["fps"] for c in s) == pytest.approx([30.0 * (1 + d) for d in (-0.0025, -0.00125, 0, 0.00125,
                                                                                         0.0025)])
    assert [len(c["frames"]) for c in a] == [int(np.ceil((2.0 - c["phase"]) * c["fps"])) for c in a]


def test_a_seed_gives_the_same_dataset(tmp_path):
    a = synthetic.generate_dataset(str(tmp_path / "a"), 6, 64, 2 ** 31 + 5)
    b = synthetic.generate_dataset(str(tmp_path / "b"), 6, 64, 2 ** 31 + 5)
    assert _digest(tmp_path / "a") == _digest(tmp_path / "b")
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert a["frames"].shape == (3, 64, 64, 3)  # 6 frames: 1 test, 2 val, 3 train


def test_the_programs_reader_reads_the_dataset(tmp_path):
    from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset

    data = synthetic.generate_dataset(str(tmp_path), 6, 64, 9)
    ds = ColibriDataset(str(tmp_path), 0, 1, "train")
    assert len(ds) == 3
    for i in range(3):
        assert np.array_equal(ds.load_image(i), data["frames"][i])
        anno = ds.load_annotations(i)
        assert np.allclose(anno["bboxes"][0], data["boxes"][i])
        assert np.allclose(anno["translations"][0], data["translations"][i])
        assert np.allclose(anno["rotations"][0, :3], data["rotvecs"][i], atol=1e-9)
        assert np.allclose(anno["coords_3d"][0], data["hands"][i])


def test_the_reference_decodes_i420_as_the_server_does():
    from hmd_ego_pose_tpu_torch.serving import frameio

    rgb = synthetic.serving_frame(1, 0, 64, 112, 0.5)
    payload = loadgen.rgb_to_i420(rgb)
    ours = i420_to_rgb(payload, 64, 112)
    assert np.array_equal(ours, frameio.i420_to_rgb(np.frombuffer(payload, np.uint8), 64, 112))
    assert np.abs(ours.astype(int) - rgb.astype(int)).mean() < 16  # chroma is subsampled 2x2


def test_a_client_that_sheds_load_skips_frames_and_every_frame_sent_is_answered():
    import socket
    import struct
    import threading
    import time

    h, w, header = 2, 4, struct.calcsize("<IBHH")
    listener = socket.create_server(("127.0.0.1", 0))

    def slow_server():  # answers each frame 0.2 s after it arrives
        conn, _ = listener.accept()
        with conn:
            while True:
                need, buf = header + h * w * 3 // 2, b""
                while len(buf) < need:
                    chunk = conn.recv(need - len(buf))
                    if not chunk:
                        return
                    buf += chunk
                time.sleep(0.2)
                conn.sendall(struct.pack("<6f", 1, 2, 3, 4, 5, 6))

    threading.Thread(target=slow_server, daemon=True).start()
    client = loadgen._Client(listener.getsockname()[1], 10.0)
    message = loadgen.frame_message(bytes(h * w * 3 // 2), h, w)
    plan = {"phase": 0.0, "fps": 20.0, "frames": [0] * 20}
    start = time.monotonic() + 0.05
    try:
        records, skipped = client.run([message], plan, start, start + 5.0, max_outstanding=1)
    finally:
        client.close()
        listener.close()
    assert skipped > 0 and len(records) + skipped == 20
    assert all(r[3] is not None and r[4] == [1, 2, 3, 4, 5, 6] for r in records)
    assert all(b[2] >= a[3] - 1e-3 for a, b in zip(records, records[1:]))  # one frame outstanding at a time
