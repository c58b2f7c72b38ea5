"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU, at a size a test run holds: serving with every answer altered
or emptied ("no detection") where the engine produces it; training with the update left out (the
state returned unchanged) and with half of each batch left out, at phi 0
and at phi 3's widths (EfficientNet-B3, a 160-filter BiFPN x6, heads x4).
A sound run of each is held to come out correct beside them.
"""

import pytest

from harness import common, loadgen, serve, train


def _serve_cell():
    return {"config": common.load_json(common.BENCH + "/configs/hmdegopose-phi0-256.json"),
            "traffic": dict(common.load_json(common.BENCH + "/traffic/hololens-30fps-i420-n2.json"),
                            clients=2, fps=2, warm_seconds=1, check_frames=4)}


PHI3 = {"phi": 3, "backbone": "efficientnet-b3", "fpn_num_filters": 160, "fpn_cell_repeats": 6, "head_repeats": 4}


def _train_cell(widths):
    conf = common.load_json(common.BENCH + "/configs/hmdegopose-phi0-256.json")
    conf.update(widths, image_size=128)
    conf["training"].update(batch_size=4, oversample=2)
    conf["train_split_frames"] = 12
    return {"config": conf, "traffic": {"kind": "train"}}


@pytest.mark.parametrize("fault, correct", [(None, True), ("alter", False), ("empty", False)])
def test_serving(fault, correct):
    cell, seed = _serve_cell(), 2 ** 31 + 101
    t = cell["traffic"]
    due = loadgen.schedule(seed, t["clients"], t["fps"], t["pool"], 2, 1, t["clock_spread"])
    out = serve.run(cell, seed, 2, False, device="cpu", fault=fault)
    assert out["failed"] == 0 and out["attempted"] == sum(len(c["frames"]) for c in due)
    assert out["correct"] is correct, out["checks"]


@pytest.mark.parametrize("widths", [{}, PHI3], ids=["phi0", "phi3"])
@pytest.mark.parametrize("fault, correct", [(None, True), ("unchanged", False), ("half", False)])
def test_training(fault, correct, widths):
    out = train.run(_train_cell(widths), 2 ** 31 + 202, 1, False, device="cpu", fault=fault)
    assert out["correct"] is correct, out["checks"]
