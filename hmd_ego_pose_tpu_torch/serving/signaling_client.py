"""node-dss signaling client (polling GET loop, POST sends) and the
workstation's offer responder.

Counterpart of ``hmd_ego_pose_tpu/serving/signaling_client.py``, the Python
twin of the reference's HMD and workstation signaler (NodeDssSignaler.cs):

* messages are JSON ``{"MessageType": 1|2|3, "Data": "...",
  "IceDataSeparator": "|"}`` (Offer=1, Answer=2, Ice=3), byte-equal to the
  JAX package's; a string ``MessageType`` ("Offer", ...) is read too;
* the client POSTs to ``{server}/data/{remote_peer_id}`` and polls
  ``{server}/data/{local_peer_id}`` every ``poll_interval`` seconds with at
  most one request in flight;
* ``on_connect`` fires once, on the first message sent (node-dss has no
  connection of its own);
* 404 means "mailbox empty", not an error.

Every HTTP call has a ``timeout``; ``stop_polling`` joins the polling thread
and raises if it hangs.  ``PoseEndpointResponder`` is the workstation half:
it answers each OFFER with the TCP pose endpoint.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Callable, Optional

OFFER = 1
ANSWER = 2
ICE = 3

_TYPE_FROM_STRING = {"offer": OFFER, "answer": ANSWER, "ice": ICE}


@dataclass
class Message:
    """node-dss wire message."""

    message_type: int
    data: str
    ice_data_separator: str = "|"

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "MessageType": self.message_type,
                "Data": self.data,
                "IceDataSeparator": self.ice_data_separator,
            }
        ).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "Message":
        obj = json.loads(raw.decode())
        mtype = obj.get("MessageType", 0)
        if isinstance(mtype, str):
            mtype = _TYPE_FROM_STRING.get(mtype.lower(), 0)
        return cls(
            message_type=int(mtype),
            data=obj.get("Data", ""),
            ice_data_separator=obj.get("IceDataSeparator", "|"),
        )


class NodeDssSignalerClient:
    """Polling signaler against a node-dss-compatible server."""

    def __init__(
        self,
        server_url: str,
        local_peer_id: str,
        remote_peer_id: str,
        poll_interval: float = 0.5,
        timeout: float = 5.0,
    ):
        if not server_url.endswith("/"):
            server_url += "/"  # the reference requires the trailing slash
        self.server_url = server_url
        self.local_peer_id = local_peer_id
        self.remote_peer_id = remote_peer_id
        self.poll_interval = poll_interval
        self.timeout = timeout

        self.on_message: Optional[Callable[[Message], None]] = None
        self.on_connect: Optional[Callable[[], None]] = None
        self.on_failure: Optional[Callable[[Exception], None]] = None

        self._connected_fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- send ---------------------------------------------------------------------
    def send(self, message: Message) -> None:
        """POST ``message`` to the remote peer's mailbox; raises (after
        ``on_failure``) when the request fails."""
        req = urllib.request.Request(
            f"{self.server_url}data/{self.remote_peer_id}",
            data=message.to_json(),
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                pass
        except (urllib.error.URLError, OSError) as exc:
            if self.on_failure:
                self.on_failure(exc)
            raise
        if not self._connected_fired:
            self._connected_fired = True
            if self.on_connect:
                self.on_connect()

    # -- poll ---------------------------------------------------------------------
    def poll_once(self) -> Optional[Message]:
        """One GET: the oldest message of the local mailbox, or None when it is
        empty (404) or the request failed (reported to ``on_failure``)."""
        try:
            with urllib.request.urlopen(
                f"{self.server_url}data/{self.local_peer_id}", timeout=self.timeout
            ) as resp:
                return Message.from_json(resp.read())
        except urllib.error.HTTPError as exc:
            if exc.code != 404 and self.on_failure:
                self.on_failure(exc)
            return None
        except (urllib.error.URLError, OSError, ValueError) as exc:
            if self.on_failure:
                self.on_failure(exc)
            return None

    def start_polling(self) -> bool:
        """Start the background poll loop; False if already polling."""
        if self._thread is not None and self._thread.is_alive():
            return False
        self._stop.clear()

        def loop():
            # one request in flight at a time, ~poll_interval apart
            while not self._stop.is_set():
                msg = self.poll_once()
                if msg is not None and self.on_message:
                    self.on_message(msg)
                    continue  # drain the mailbox without waiting
                self._stop.wait(self.poll_interval)

        self._thread = threading.Thread(target=loop, name="signaling-poll", daemon=True)
        self._thread.start()
        return True

    def stop_polling(self) -> None:
        """Stop the poll loop; raises if its thread is still alive after one
        request's timeout and one poll interval."""
        self._stop.set()
        if self._thread is not None:
            thread, self._thread = self._thread, None
            thread.join(timeout=self.timeout + self.poll_interval + 1.0)
            if thread.is_alive():
                raise RuntimeError("the signaling poll thread did not stop")

    def wait_for(self, message_type: int, timeout: float = 10.0) -> Optional[Message]:
        """Poll until a message of ``message_type`` arrives (others go to
        ``on_message``); None after ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            msg = self.poll_once()
            if msg is not None:
                if msg.message_type == message_type:
                    return msg
                if self.on_message:
                    self.on_message(msg)
                continue
            time.sleep(max(0.0, min(self.poll_interval, deadline - time.monotonic())))
        return None


class PoseEndpointResponder:
    """Workstation-side bootstrap: answers OFFERs with the pose endpoint.

    The reference's offer and answer carry SDP for an RTP media path; here the
    media path is the framed TCP pose stream, so the ANSWER's ``Data`` is JSON
    ``{"host", "port", "frame_kinds"}`` that the client dials.
    """

    def __init__(self, signaler: NodeDssSignalerClient, host: str, port: int):
        self.signaler = signaler
        self.endpoint = {"host": host, "port": port, "frame_kinds": ["rgb8", "i420", "nv12"]}
        signaler.on_message = self._handle

    def _handle(self, msg: Message) -> None:
        if msg.message_type == OFFER:
            self.signaler.send(Message(ANSWER, json.dumps(self.endpoint)))

    def start(self) -> None:
        self.signaler.start_polling()

    def stop(self) -> None:
        self.signaler.stop_polling()
