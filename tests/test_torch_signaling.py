"""The port's node-dss signaling against the JAX package's, and the whole
bootstrap on the CPU.

* ``Message.to_json`` byte-equal to JAX's, string ``MessageType``s read alike.
* The port's signaler client against the JAX ``SignalingServer`` and the
  JAX client against the port's: FIFO order, peer isolation, the 404 cases.
* A poll that returns past ``wait_for``'s deadline: the JAX client's sleep
  raises (Queue C-1 of the roadmap), the port's returns None.
* The port's server: HTTP/1.1, ``stop`` joins its thread.
* ``cli serve``'s four signaling flags (the JAX defaults) and
  ``cli.start_signaling``: a whole offer/answer bootstrap, then I420 and NV12
  frames on the port's real engine (the shipped artifact, ``device="cpu"``),
  each answered with the packet of the RGB8 frame it decodes to.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import chip_smoke
from hmd_ego_pose_tpu.serving import signaling as jax_signaling
from hmd_ego_pose_tpu.serving import signaling_client as jax_client
from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.data.image import read_png
from hmd_ego_pose_tpu_torch.serving import frameio, protocol, signaling, signaling_client
from hmd_ego_pose_tpu_torch.serving.server import PoseClient, PoseServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "trained", "syn1000_phi0_576ep_handrel_int8.npz")
PACKAGES = {"port": (signaling, signaling_client), "jax": (jax_signaling, jax_client)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _url(server):
    host, port = server.address[:2]
    return f"http://{host}:{port}/"


@pytest.fixture(params=[("port", "jax"), ("jax", "port"), ("port", "port")], ids=lambda p: "-on-".join(p))
def pair(request):
    """(client module, a started server of the other package or the port's own)."""
    client_pkg, server_pkg = request.param
    server = PACKAGES[server_pkg][0].SignalingServer(port=0).start()
    yield PACKAGES[client_pkg][1], server
    server.stop()


def test_message_json_byte_equal_to_jax():
    for mtype, data in [(1, "v=0\r\no=- 1 2 IN IP4 127.0.0.1"), (2, json.dumps({"host": "h", "port": 1})),
                        (3, "candidate:1|0|audio"), (0, "ünï€ode")]:
        port, jax = signaling_client.Message(mtype, data), jax_client.Message(mtype, data)
        assert port.to_json() == jax.to_json()
        assert signaling_client.Message.from_json(port.to_json()) == port
    for raw in [b'{"MessageType": "Offer", "Data": "sdp", "IceDataSeparator": "|"}',
                b'{"MessageType": "answer", "Data": "x"}', b'{"MessageType": "Ice"}',
                b'{"MessageType": "bogus", "Data": "y", "IceDataSeparator": ";"}', b'{"MessageType": 2}']:
        port, jax = signaling_client.Message.from_json(raw), jax_client.Message.from_json(raw)
        assert (port.message_type, port.data, port.ice_data_separator) == (
            jax.message_type, jax.data, jax.ice_data_separator)
        assert port.to_json() == jax.to_json()
    assert (signaling_client.OFFER, signaling_client.ANSWER, signaling_client.ICE) == (1, 2, 3)


def test_clients_and_servers_across_packages(pair):
    client_mod, server = pair
    url = _url(server)
    alice = client_mod.NodeDssSignalerClient(url, "alice", "bob", poll_interval=0.01, timeout=5.0)
    bob = client_mod.NodeDssSignalerClient(url.rstrip("/"), "bob", "alice", poll_interval=0.01, timeout=5.0)
    carol = client_mod.NodeDssSignalerClient(url, "carol", "alice", poll_interval=0.01, timeout=5.0)
    assert bob.server_url == url
    assert bob.poll_once() is None  # GET before any POST: 404, an empty mailbox
    connects = []
    alice.on_connect = lambda: connects.append(1)
    for i in range(3):
        alice.send(client_mod.Message(client_mod.OFFER, f"m{i}"))
    carol.send(client_mod.Message(client_mod.ICE, "c0"))
    assert connects == [1]  # fired once, on the first send
    assert carol.poll_once() is None  # carol's own mailbox is empty: isolation
    got = [bob.poll_once() for _ in range(4)]
    assert [m.data for m in got[:3]] == ["m0", "m1", "m2"] and got[3] is None  # FIFO, then 404
    assert alice.poll_once().data == "c0"
    assert alice.poll_once() is None
    # other paths are 404, and a failed poll is reported, not raised
    for path in ("data/x/extra", "data/", "other/alice", ""):
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(url + path, timeout=5.0)
        assert exc.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(urllib.request.Request(url + "data/", data=b"x", method="POST"), timeout=5.0)
    assert exc.value.code == 404
    # background polling drains the mailbox through on_message; wait_for skips to its type
    seen, arrived = [], threading.Event()
    bob.on_message = lambda m: (seen.append(m.data), len(seen) == 2 and arrived.set())
    alice.send(client_mod.Message(client_mod.ICE, "i0"))
    alice.send(client_mod.Message(client_mod.ICE, "i1"))
    assert bob.start_polling() and not bob.start_polling()
    try:
        assert arrived.wait(10.0)
    finally:
        bob.stop_polling()
    assert seen == ["i0", "i1"]
    alice.send(client_mod.Message(client_mod.ICE, "skipped"))
    alice.send(client_mod.Message(client_mod.ANSWER, "the answer"))
    others = []
    bob.on_message = lambda m: others.append(m.data)
    assert bob.wait_for(client_mod.ANSWER, timeout=10.0).data == "the answer"
    assert others == ["skipped"]
    assert bob.wait_for(client_mod.ANSWER, timeout=0.05) is None


@pytest.mark.parametrize("package", ["jax", "port"])
def test_a_poll_that_ends_past_the_deadline(package, monkeypatch):
    """The C-1 flake of ``test_clients_and_servers_across_packages[jax-on-port]``,
    pinned: a ``wait_for`` whose poll returns past its deadline.  The JAX
    client then sleeps ``deadline - time.time()``, which is negative, and
    ``time.sleep`` raises ``ValueError``
    (``hmd_ego_pose_tpu/serving/signaling_client.py:171``); the port's client
    clamps the sleep at zero and returns None.  No request is made."""
    client_mod = PACKAGES[package][1]
    client = client_mod.NodeDssSignalerClient("http://127.0.0.1:9/", "bob", "alice", poll_interval=0.01,
                                              timeout=1.0)

    def late_poll():
        time.sleep(0.06)  # past the 0.05 s deadline
        return None

    monkeypatch.setattr(client, "poll_once", late_poll)
    if package == "jax":
        with pytest.raises(ValueError):
            client.wait_for(client_mod.ANSWER, timeout=0.05)
    else:
        assert client.wait_for(client_mod.ANSWER, timeout=0.05) is None


def test_port_server_speaks_http_1_1_and_stop_joins():
    server = signaling.SignalingServer(port=0).start()
    host, port = server.address
    try:
        import http.client

        conn = http.client.HTTPConnection(host, port, timeout=5.0)
        conn.request("POST", "/data/p", body=b"abc")
        resp = conn.getresponse()
        assert (resp.status, resp.version, resp.read()) == (200, 11, b"")
        conn.request("GET", "/data/p")  # the same connection: kept alive
        resp = conn.getresponse()
        assert (resp.status, resp.read()) == (200, b"abc")
        conn.close()
    finally:
        server.stop(timeout=5.0)
    assert not any(t.name == "signaling-server" and t.is_alive() for t in threading.enumerate())
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://{host}:{port}/data/p", timeout=2.0)
    # a failed send is reported and raised; a failed poll only reported
    failures = []
    client = signaling_client.NodeDssSignalerClient(f"http://{host}:{port}/", "a", "b", timeout=2.0)
    client.on_failure = failures.append
    with pytest.raises(OSError):
        client.send(signaling_client.Message(signaling_client.OFFER, "x"))
    assert client.poll_once() is None
    assert len(failures) == 2


def test_serve_signaling_flags_and_advertised_host():
    args = cli.build_parser().parse_args(["serve", "--device", "cpu"])
    assert (args.signaling_url, args.local_peer_id, args.remote_peer_id, args.advertise_host) == (
        None, "workstation", "hmd", None)
    assert cli.start_signaling(args, None) is None

    class Bound:
        address = ("0.0.0.0", 4242)

    sig = signaling.SignalingServer(port=0).start()
    try:
        for extra, want in [([], "127.0.0.1"), (["--advertise-host", "10.1.2.3"], "10.1.2.3")]:
            args = cli.build_parser().parse_args(
                ["serve", "--signaling-url", _url(sig), "--local-peer-id", "ws", "--remote-peer-id", "dev"] + extra)
            responder = cli.start_signaling(args, Bound(), poll_interval=0.01)
            try:
                assert responder.endpoint == {"host": want, "port": 4242, "frame_kinds": ["rgb8", "i420", "nv12"]}
                hmd = jax_client.NodeDssSignalerClient(_url(sig), "dev", "ws", poll_interval=0.01)
                hmd.send(jax_client.Message(jax_client.OFFER, "sdp"))
                answer = hmd.wait_for(jax_client.ANSWER, timeout=10.0)
                assert json.loads(answer.data) == responder.endpoint
            finally:
                responder.stop()
    finally:
        sig.stop()


def test_bootstrap_then_yuv_frames_on_the_real_engine_on_the_cpu():
    frames = [read_png(os.path.join(REPO, "tests", "goldens", f"handrel_ckpt_frame_{i}.png")) for i in (0, 4)]
    h, w = frames[0].shape[:2]
    engine = cli.build_engine(ARTIFACT, "cpu", frame_size=h, max_batch_size=1, score_threshold=0.1)
    server = PoseServer(engine, host="0.0.0.0", port=0).start()
    sig = signaling.SignalingServer(port=0).start()
    responder = None
    try:
        args = cli.build_parser().parse_args(["serve", "--device", "cpu", "--signaling-url", _url(sig)])
        responder = cli.start_signaling(args, server, poll_interval=0.01)
        hmd = signaling_client.NodeDssSignalerClient(_url(sig), "hmd", "workstation", poll_interval=0.01)
        hmd.send(signaling_client.Message(signaling_client.OFFER, "pseudo-sdp"))
        answer = hmd.wait_for(signaling_client.ANSWER, timeout=10.0)
        assert answer is not None, "no answer from the endpoint responder"
        endpoint = json.loads(answer.data)
        assert endpoint["host"] == "127.0.0.1" and endpoint["port"] == server.address[1]
        with PoseClient(endpoint["host"], endpoint["port"], timeout=60.0) as client:
            for frame in frames:
                for payload, kind, convert in zip(chip_smoke.rgb_to_yuv420(frame), (protocol.KIND_I420, protocol.KIND_NV12),
                                                  (frameio.i420_to_rgb, frameio.nv12_to_rgb)):
                    pose = client.infer_encoded(payload, kind, h, w)
                    assert pose is not None, "the decoded golden frame must stay a detection"
                    rgb = convert(np.frombuffer(payload, np.uint8), h, w)
                    want = client.infer(rgb)
                    assert protocol.encode_pose_packet(*pose) == protocol.encode_pose_packet(*want)
    finally:
        if responder is not None:
            responder.stop()
        server.stop(timeout=10.0)
        sig.stop()
    assert engine.stats()["total"]["count"] == 2 * 2 * len(frames)
    assert not any(t.name in ("pose-server", "signaling-server", "signaling-poll") and t.is_alive()
                   for t in threading.enumerate())
