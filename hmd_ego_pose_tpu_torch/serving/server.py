"""TCP pose-streaming server and a blocking client.

Counterpart of ``hmd_ego_pose_tpu/serving/server.py``: clients send frame
messages (``serving/protocol.py``: RGB8, I420 or NV12), the server answers
each with one 24-byte pose packet.  One receive thread per connection feeds
the shared ``InferenceEngine``, whose dispatcher batches across clients.  Every wait is
bounded: ``stop`` joins the acceptor thread with a timeout, and the client's
socket has a timeout.

While ``utils/profiler.py::RECORDER`` is on, each connection's thread
(``pose-conn-<n>``, n counting the server's connections from 1) records
four spans a frame under the frame's id: ``server.recv`` (from the
header's arrival to the payload's last byte; the wait for the next header
is none), ``server.decode``, ``server.wait`` (submit to the engine's answer,
the parent of the engine's spans of the frame) and ``server.send`` (the
packet's encoding and ``sendall``).
"""

from __future__ import annotations

import itertools
import socket
import socketserver
import threading
from typing import Optional

import numpy as np

from hmd_ego_pose_tpu_torch.serving import protocol
from hmd_ego_pose_tpu_torch.serving.engine import InferenceEngine
from hmd_ego_pose_tpu_torch.utils.profiler import RECORDER


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        engine: InferenceEngine = self.server.engine  # type: ignore[attr-defined]
        timeout = self.server.request_timeout  # type: ignore[attr-defined]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        threading.current_thread().name = f"pose-conn-{next(self.server.connections)}"  # type: ignore[attr-defined]
        while True:
            header = _recv_exact(sock, protocol.HEADER_BYTES)
            if header is None:
                return
            rid = RECORDER.next_id()
            with RECORDER.span("server.recv", rid):
                kind, h, w = protocol.decode_frame_header(header)
                payload = _recv_exact(sock, protocol.payload_size(kind, h, w))
            if payload is None:
                return
            with RECORDER.span("server.decode", rid):
                frame = protocol.decode_frame_message(header + payload)
            with RECORDER.span("server.wait", rid):
                result = engine.infer_blocking(frame, timeout=timeout)
            with RECORDER.span("server.send", rid):
                sock.sendall(protocol.no_detection_packet() if result is None
                             else protocol.encode_pose_packet(*result))


class _ThreadingServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class PoseServer:
    """Lifecycle wrapper: engine + TCP acceptor.  ``port=0`` picks a free port."""

    def __init__(self, engine: InferenceEngine, host: str = "127.0.0.1", port: int = 0,
                 request_timeout: float = 60.0):
        self.engine = engine
        self._server = _ThreadingServer((host, port), _Handler)
        self._server.engine = engine  # type: ignore[attr-defined]
        self._server.request_timeout = request_timeout  # type: ignore[attr-defined]
        self._server.connections = itertools.count(1)  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        return self._server.server_address

    def start(self):
        self.engine.start()
        self._thread = threading.Thread(target=self._server.serve_forever, name="pose-server",
                                        kwargs={"poll_interval": 0.05}, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        """Stop accepting, close the socket, stop the engine; raises on a thread that hangs."""
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise RuntimeError(f"pose server thread did not stop within {timeout} s")
        self.engine.stop(timeout=timeout)


class PoseClient:
    """Minimal blocking client; every send and receive is bounded by ``timeout``."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def infer(self, frame: np.ndarray):
        """One RGB8 frame -> (rotation_rad, translation_m), or None without a detection."""
        return self._roundtrip(protocol.encode_frame_message(frame))

    def infer_encoded(self, payload: bytes, kind: int, height: int, width: int):
        """Send an I420/NV12 payload (the reference HMD's frame formats); as ``infer``."""
        return self._roundtrip(protocol.encode_raw_frame_message(payload, kind, height, width))

    def _roundtrip(self, message: bytes):
        self.sock.sendall(message)
        packet = _recv_exact(self.sock, protocol.POSE_PACKET_BYTES)
        if packet is None:
            raise ConnectionError("server closed the connection")
        rotation, translation = protocol.decode_pose_packet(packet)
        if np.isnan(rotation).any():
            return None
        return rotation, translation

    def close(self):
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
