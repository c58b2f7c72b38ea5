"""Signaling server: in-memory per-peer FIFO mailboxes over HTTP/1.1.

Counterpart of ``hmd_ego_pose_tpu/serving/signaling.py``, the functional
equivalent of the reference's node-dss service, which WebRTC peers use to
exchange offers, answers and ICE candidates before the media path exists:

    POST /data/<peer-id>   enqueue a message for <peer-id>  -> 200
    GET  /data/<peer-id>   dequeue the oldest message       -> 200 body | 404
    any other path                                           -> 404

Mailboxes are in memory and lossy by design, as node-dss's are.  The pose
transport (``serving/server.py``) does not need signaling; an HMD that keeps
the WebRTC-style bootstrap offers here and dials the endpoint it is answered
with (``serving/signaling_client.py``).  ``stop`` joins the serving thread
with a timeout and raises if it hangs.
"""

from __future__ import annotations

import collections
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Deque, Dict, Optional, Tuple


class _Mailboxes:
    def __init__(self):
        self._boxes: Dict[str, Deque[bytes]] = collections.defaultdict(collections.deque)
        self._lock = threading.Lock()

    def push(self, peer: str, data: bytes) -> None:
        with self._lock:
            self._boxes[peer].append(data)

    def pop(self, peer: str) -> Optional[bytes]:
        with self._lock:
            box = self._boxes.get(peer)
            if not box:
                return None
            return box.popleft()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # a response's headers and body go out in two writes: with Nagle's
    # algorithm the body would wait for the client's delayed ACK (~40 ms)
    disable_nagle_algorithm = True

    def _peer(self) -> Optional[str]:
        parts = self.path.strip("/").split("/")
        if len(parts) == 2 and parts[0] == "data" and parts[1]:
            return parts[1]
        return None

    def do_POST(self):
        peer = self._peer()
        if peer is None:
            self.send_error(404)
            return
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        self.server.mailboxes.push(peer, body)  # type: ignore[attr-defined]
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self):
        peer = self._peer()
        data = self.server.mailboxes.pop(peer) if peer else None  # type: ignore[attr-defined]
        if data is None:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):  # quiet
        pass


class SignalingServer:
    """The mailbox service on ``host:port``; ``port=0`` picks a free port."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.mailboxes = _Mailboxes()  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address[:2]

    def start(self) -> "SignalingServer":
        self._thread = threading.Thread(target=self._server.serve_forever, name="signaling-server",
                                        kwargs={"poll_interval": 0.05}, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop serving and close the socket; raises if the thread does not stop within ``timeout``."""
        if self._thread is not None:
            self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise RuntimeError(f"signaling server thread did not stop within {timeout} s")
