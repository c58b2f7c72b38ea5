"""The program's spans against the device's intervals (``harness/spans.py``),
on hand-made timelines: self time, gap labels, the idle split and the five
readings; on the card, the aligned timeline beside the one it extends."""

import pytest

from harness import spans
from harness.trace import Trace
from hmd_ego_pose_tpu_torch.utils.profiler import Span

MS = 1_000_000


def _span(name, s, e, sid, parent=0, rid=0, thread="engine-dispatch", attrs=None):
    return Span(name, int(s * MS), int(e * MS), thread, sid, parent, rid, attrs)


def _serving():
    """Two frames: frame 1 received at 1 ms, batched alone and replayed
    until 6 ms; frame 2 received at 12 ms and replayed until 15 ms.  The
    device runs [6, 10] and [15, 18] of a [0, 20] ms slice."""
    b1, b2 = {"batch": 1, "rows": 1, "frames": (1,)}, {"batch": 1, "rows": 1, "frames": (2,)}
    got = [
        _span("server.recv", 1, 2, 1, rid=1, thread="pose-conn-1"),
        _span("server.decode", 2, 3, 2, rid=1, thread="pose-conn-1"),
        _span("server.wait", 3, 11, 3, rid=1, thread="pose-conn-1"),
        _span("engine.queue", 3, 4, 4, parent=3, rid=1, thread="queue"),
        _span("engine.batch", 4, 6, 5, rid=11, attrs=b1),
        _span("engine.pack", 4, 4.5, 6, parent=5, rid=11, attrs=b1),
        _span("engine.upload", 4.5, 5, 7, parent=5, rid=11, attrs=b1),
        _span("engine.replay", 5, 6, 8, parent=5, rid=11, attrs=b1),
        _span("engine.device_wait", 6, 10, 9, rid=11, thread="engine-resolve", attrs=b1),
        _span("server.send", 11, 11.5, 10, rid=1, thread="pose-conn-1"),
        _span("server.recv", 12, 12.5, 12, rid=2, thread="pose-conn-2"),
        _span("server.decode", 12.5, 13, 13, rid=2, thread="pose-conn-2"),
        _span("server.wait", 13, 19, 14, rid=2, thread="pose-conn-2"),
        _span("engine.batch", 13, 15, 15, rid=21, attrs=b2),
        _span("engine.pack", 13, 13.5, 16, parent=15, rid=21, attrs=b2),
        _span("engine.upload", 13.5, 14.5, 17, parent=15, rid=21, attrs=b2),
        _span("engine.replay", 14.5, 15, 18, parent=15, rid=21, attrs=b2),
        _span("server.send", 19, 19.25, 19, rid=2, thread="pose-conn-2"),
    ]
    device = [(6 * MS, 10 * MS, "engine batch of 1"), (15 * MS, 18 * MS, "engine batch of 1")]
    return Trace(device, [], 0, 20 * MS), got


def test_self_time_labels_win_over_their_parents():
    trace, got = _serving()
    lanes = spans.self_time(got)
    batch = [(s, e) for s, e, label in lanes["work"] if label == "engine-dispatch:engine.batch"]
    assert batch == []  # the batch's children cover it: no self time left
    waits = {label for _, _, label in lanes["wait"]}
    assert waits == {"pose-conn-1:server.wait", "pose-conn-2:server.wait", "queue:engine.queue",
                     "engine-resolve:engine.device_wait"}
    # [10, 15] idle: frame 2's upload (1 ms) beats its pack (0.5 ms), its parent none;
    # the waits overlap it longer but rank after any work
    labels = dict((round(length * 1e3, 6), label) for label, length in spans.label_gaps(trace, got, spans.NO_FRAME))
    assert labels[5.0] == "engine-dispatch:engine.upload"
    # [0, 6]: frame 1's receive, decode and replay (1 ms each; the label's name breaks the tie)
    assert labels[6.0] == "pose-conn-1:server.recv"
    # with the frames' time in the server: [10, 15] holds no frame for 2 ms, the upload 1 ms;
    # [0, 6] holds none for 1 ms against 1 ms of receive (a tie goes to the span)
    labels = dict((round(length * 1e3, 6), label) for label, length in spans.serve_gaps(trace, got))
    assert labels == {5.0: spans.NO_FRAME, 6.0: "pose-conn-1:server.recv", 2.0: spans.NO_FRAME}


def test_a_gap_with_no_span_reads_no_frame_in_the_server():
    trace, got = _serving()
    assert spans.label_gaps(Trace([], [], 30 * MS, 40 * MS), got, spans.NO_FRAME) == [
        [spans.NO_FRAME, pytest.approx(0.010)]]
    assert spans.label_gaps(trace, [], spans.NO_FRAME)[0][0] == spans.NO_FRAME


def test_held_and_unheld_idle_add_up_to_the_idle_share():
    trace, got = _serving()
    split = spans.serve_idle_split(trace, got)
    # idle [0, 6] + [10, 15] + [18, 20] = 13 of 20 ms; held: [1, 6] (frame 1) + [12, 15] (frame 2)
    assert split["idle_pct"] == pytest.approx(65.0)
    assert split["held_pct"] == pytest.approx(40.0)
    assert split["no_frame_pct"] == pytest.approx(25.0)
    assert split["held_pct"] + split["no_frame_pct"] == pytest.approx(100.0 * (1.0 - trace.busy_s / trace.window_s))
    # frame 1 submitted before the recording: no spans of its own, id 0 in its batch; it holds from the start
    early = [s._replace(attrs={"batch": 1, "rows": 1, "frames": (0,)}) if s.rid == 11 else s
             for s in got if s.rid != 1]
    assert spans.serve_idle_split(trace, early)["held_pct"] == pytest.approx(100.0 * (6 + 3) / 20)


def test_serving_readings():
    _, got = _serving()
    # handler: frame 1 1 + 1 + 0.5, frame 2 0.5 + 0.5 + 0.25 ms
    assert spans.handler_ms(got) == pytest.approx((2.5 + 1.25) / 2)
    # dispatch: 0.5 + 0.5 + 1 and 0.5 + 1 + 0.5 ms
    assert spans.dispatch_ms(got) == pytest.approx(2.0)
    assert spans.upload_ms(got) == {"p50": pytest.approx(0.75), "p90": pytest.approx(0.95), "batches": 2}
    assert spans.handler_ms([]) is None and spans.serve_idle_split(Trace([], [], 0, 0), got) is None


def _training():
    """One epoch of two steps on the main thread; the device runs [3, 9] and
    [12, 18] of a [0, 20] ms slice; host operations from the profiler."""
    t = "MainThread"
    got = [_span("train.epoch", 0, 20, 1, rid=1, thread=t),
           _span("train.indices", 0, 1, 2, parent=1, rid=1, thread=t)]
    sid = 3
    for rid, (s0, draws, stage, wait, replay) in ((10, (1, 1.5, 1, 0.5, 0.5)), (20, (9, 2, 1.5, 1, 0.5))):
        step = sid
        got.append(_span("train.step", s0, s0 + draws + stage + replay, step, parent=1, rid=rid, thread=t))
        got.append(_span("train.draws", s0, s0 + draws, sid + 1, parent=step, rid=rid, thread=t))
        got.append(_span("train.stage", s0 + draws, s0 + draws + stage, sid + 2, parent=step, rid=rid, thread=t))
        got.append(_span("train.stage_wait", s0 + draws, s0 + draws + wait, sid + 3, parent=sid + 2, rid=rid,
                         thread=t))
        got.append(_span("train.replay", s0 + draws + stage, s0 + draws + stage + replay, sid + 4, parent=step,
                         rid=rid, thread=t))
        sid += 5
    got.append(_span("train.epoch_end", 18, 20, sid, parent=1, rid=1, thread=t))
    device = [(3 * MS, 9 * MS, "k"), (12 * MS, 18 * MS, "k")]
    host = [(9 * MS, 11 * MS, "aten::randn"), (0, 1 * MS, "aten::copy_")]
    return Trace(device, host, 0, 20 * MS), got


def test_training_readings_and_labels():
    trace, got = _training()
    # per step: draws + stage - wait = 1.5 + 1 - 0.5 and 2 + 1.5 - 1; the replay is a wait
    assert spans.host_step_ms(got) == pytest.approx((2.0 + 2.5) / 2)
    held = spans.train_held_idle_pct(trace, got)
    lanes = spans.self_time(got)
    assert {label for _, _, label in lanes["wait"]} == {"MainThread:train.stage_wait", "MainThread:train.replay"}
    main = spans._merge([(s, e) for s, e, _ in lanes["work"]])
    assert held == pytest.approx(100.0 * spans._overlap(spans.idle(trace), main) / (20 * MS))
    # idle [0, 3], [9, 12], [18, 20]; the main thread's self time there, the waits left out:
    # indices [0, 1] + draws [1, 2.5] (the stage's wait is [2.5, 3]), draws [9, 11] (the
    # stage's wait [11, 12]), epoch_end [18, 20]: 6.5 of 20 ms
    assert held == pytest.approx(32.5)
    gaps = spans.label_gaps(trace, got, spans.NO_SPAN, host_ops=True)
    assert gaps == [["MainThread:train.draws/aten::copy_", pytest.approx(0.003)],  # draws 1.5 ms, indices 1
                    ["MainThread:train.draws/aten::randn", pytest.approx(0.003)],  # draws 2 ms, the wait after
                    ["MainThread:train.epoch_end/no host event traced", pytest.approx(0.002)]]
    # [3.5, 4]: the host blocked in the first step's replay holds none of the idle, and the gap reads the replay
    blocked = Trace([], [], int(3.5 * MS), 4 * MS)
    assert spans.train_held_idle_pct(blocked, got) == 0.0
    assert spans.label_gaps(blocked, got, spans.NO_SPAN) == [["MainThread:train.replay", pytest.approx(0.0005)]]
    assert spans.host_step_ms([]) is None and spans.train_held_idle_pct(trace, []) is None


@pytest.mark.cuda
def test_aligned_timeline_keeps_the_timelines_output(card):
    import torch

    timeline = spans.AlignedTimeline(lambda n: "spin")
    spin = timeline.wrap(lambda n: torch.cuda._sleep(n))
    with timeline.recorded():
        spin(100000)
        spin(100000)
    out = timeline.trace()
    plain = [(int(timeline.marker.elapsed_time(s) * 1e6), int(timeline.marker.elapsed_time(e) * 1e6), n)
             for s, e, n in timeline.pairs]
    assert out.device == sorted(plain) and out.host == [] and (out.t0, out.t1) == (0, timeline.t1_ns - timeline.t0_ns)
    assert len(out.aligned.device) == 2 and out.aligned.t0 == timeline.t0_ns
    assert abs(out.marker_behind_ms) < 5.0
