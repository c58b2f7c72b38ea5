"""Open-loop HoloLens clients over loopback TCP, in a process of their own.

Each client is a headset camera: one TCP connection to the pose server,
frames due at ``start + phase + k / rate``, sent when due whatever has come
back (open loop), each answered by one 24-byte pose packet, in order.
Headsets do not lock their cameras to one another: each has a phase drawn
from the seed within one frame interval and a frame clock of its own, a
little off the nominal rate, so their phases drift through each other
several times a window and the collisions of their frames average out.
A frame's round trip runs from when it was due to when its packet arrived,
so a stall counts against every frame due behind it; how late each send
left is recorded too.  A client given ``max_outstanding`` skips a frame
that falls due while that many of its frames are unanswered, as a headset
streaming live video drops a stale frame; skipped frames are counted, not
sent, and ask for no answer.

Run as a script by the harness (``python loadgen.py``): it reads one JSON
line of parameters from stdin, renders the frame pool, answers
``{"ready": ...}``, then runs each ``{"cmd": "run", ...}`` line it is sent
and answers with that phase's records, until ``{"cmd": "quit"}``.  It
imports neither torch nor the program.
"""

from __future__ import annotations

import json
import os
import select
import socket
import struct
import sys
import threading
import time
from typing import Dict, List

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness.synthetic import serving_frame  # noqa: E402

MAGIC, KIND_I420 = 0x48454750, 1
PACKET = 24


def rgb_to_i420(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> I420 bytes (BT.601 limited range, chroma
    averaged over 2x2)."""
    x = rgb.astype(np.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16
    h, w = rgb.shape[:2]
    q = x.reshape(h // 2, 2, w // 2, 2, 3).sum(axis=(1, 3))
    r2, g2, b2 = q[..., 0], q[..., 1], q[..., 2]
    u = ((-38 * r2 - 74 * g2 + 112 * b2 + 512) >> 10) + 128
    v = ((112 * r2 - 94 * g2 - 18 * b2 + 512) >> 10) + 128
    planes = [np.clip(p, 0, 255).astype(np.uint8).reshape(-1) for p in (y, u, v)]
    return b"".join(p.tobytes() for p in planes)


def frame_message(payload: bytes, height: int, width: int) -> bytes:
    return struct.pack("<IBHH", MAGIC, KIND_I420, height, width) + payload


def schedule(seed: int, clients: int, fps: float, pool: int, seconds: float, salt: int,
             clock_spread: float = 0.0) -> List[Dict]:
    """Per client: its phase within one frame interval, its frame rate and
    the pool index of each of its frames due in ``[0, seconds)``; the same
    for a seed and salt.  The rates lie evenly over ``fps * (1 +- clock_spread)``
    and the seed deals them to the clients, so every seed offers the same
    load; the phases are drawn from the seed."""
    rng = np.random.RandomState([seed % (2 ** 32), 0x10AD, salt])
    offsets = np.linspace(-clock_spread, clock_spread, clients) if clients > 1 else np.zeros(1)
    rates = fps * (1.0 + offsets[rng.permutation(clients)])
    phases = rng.uniform(0.0, 1.0 / fps, clients)
    out = []
    for c in range(clients):
        n = int(np.ceil((seconds - phases[c]) * rates[c]))
        out.append({"phase": float(phases[c]), "fps": float(rates[c]),
                    "frames": rng.randint(0, pool, size=n).tolist()})
    return out


class _Client:
    def __init__(self, port: int, timeout: float):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def run(self, messages: List[bytes], plan: Dict, start: float, deadline: float, max_outstanding: int = 0):
        """Send ``plan``'s frames when due, read their packets; returns the
        records [[pool index, due, sent, received or None, packet floats],
        ...] of every frame not skipped, in seconds from ``start`` (one the
        sender never reached has neither sent nor received), and the number
        of frames skipped."""
        frames = plan["frames"]
        due = [start + plan["phase"] + k / plan["fps"] for k in range(len(frames))]
        order: List[int] = []  # the frames sent, in order: packets come back in this order
        sent: Dict[int, float] = {}
        skipped = set()
        got = [0]
        done = threading.Event()

        def sender():
            try:
                for k, idx in enumerate(frames):
                    wait = due[k] - time.monotonic()
                    if wait > 0:
                        time.sleep(wait)
                    if max_outstanding and len(order) - got[0] >= max_outstanding:
                        skipped.add(k)
                        continue
                    sent[k] = time.monotonic()
                    order.append(k)
                    self.sock.sendall(messages[idx])
            except OSError:
                pass
            finally:
                done.set()

        thread = threading.Thread(target=sender, daemon=True)
        thread.start()
        recv: Dict[int, float] = {}
        packets: Dict[int, List] = {}
        buf = bytearray()
        try:
            while time.monotonic() < deadline:
                if done.is_set() and got[0] == len(order):
                    break
                if not select.select([self.sock], [], [], 0.05)[0]:
                    continue
                chunk = self.sock.recv(65536)
                if not chunk:
                    raise ConnectionError("the server closed the connection")
                now = time.monotonic()
                buf.extend(chunk)
                while len(buf) >= PACKET:
                    k = order[got[0]]
                    recv[k] = now
                    packets[k] = list(struct.unpack("<6f", bytes(buf[:PACKET])))
                    del buf[:PACKET]
                    got[0] += 1
        except (ConnectionError, OSError):
            pass  # what never came stays None: a missing answer
        thread.join(timeout=max(0.1, deadline - time.monotonic()))
        records = [[frames[k], due[k] - start, sent[k] - start if k in sent else None,
                    recv[k] - start if k in recv else None,
                    [None if v != v else v for v in packets[k]] if k in packets else None]
                   for k in range(len(frames)) if k not in skipped]
        return records, len(skipped)

    def close(self):
        self.sock.close()


def main() -> None:
    spec = json.loads(sys.stdin.readline())
    h, w = spec["frame_height"], spec["frame_width"]
    messages = [frame_message(rgb_to_i420(serving_frame(spec["seed"], i, h, w, spec["focal_scale"])), h, w)
                for i in range(spec["pool"])]
    print(json.dumps({"ready": len(messages)}), flush=True)
    clients: List[_Client] = []
    try:
        for line in sys.stdin:
            cmd = json.loads(line)
            if cmd["cmd"] == "quit":
                break
            if not clients:
                clients = [_Client(cmd["port"], spec.get("timeout", 60.0)) for _ in range(spec["clients"])]
            plans = schedule(spec["seed"], spec["clients"], spec["fps"], spec["pool"], cmd["seconds"], cmd["salt"],
                             spec.get("clock_spread", 0.0))
            start = cmd["start"]
            deadline = start + cmd["seconds"] + cmd["grace"]
            results: List = [None] * len(clients)

            def one(c):
                results[c] = clients[c].run(messages, plans[c], start, deadline, spec.get("max_outstanding", 0))

            threads = [threading.Thread(target=one, args=(c,), daemon=True) for c in range(len(clients))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=max(1.0, deadline - time.monotonic() + 5.0))
            print(json.dumps({"phase": cmd["salt"], "clients": [r[0] if r else None for r in results],
                              "skipped": sum(r[1] for r in results if r)}), flush=True)
    finally:
        for c in clients:
            c.close()


if __name__ == "__main__":
    main()
