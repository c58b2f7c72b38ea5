"""The controls come out not correct, at the cells' own sizes, on the card.

Serving: the reference computed in float8 in the program's place (the
precision below the bfloat16 the configuration states) answers a seed's
sample of pool frames; its gaps to the float32 reference break a limit.
Training: the reference run in TF32 (below float32 with TF32 off) through
three steps of a seed's batches; its gaps to the float32 reference break
a limit.  Three seeds each.  ``benchmark/tools/readings.py`` prints the
same readings beside the program's.
"""

import os

import numpy as np
import pytest
import torch

from harness import common

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


def _limits(config):
    return common.load_json(os.path.join(common.BENCH, "reference", "limits", config + ".json"))


def _broken(gaps, limits):
    return [k for k in limits if gaps[k] > limits[k]]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_the_float8_control_fails_serving(card, seed):
    from harness import serve
    from harness.loadgen import rgb_to_i420
    from harness.synthetic import serving_frame
    from reference import serve_check
    from reference.model import Widths, load_artifact

    cell = common.cell("serve-phi0-256-hmd")
    conf, traffic = cell["config"], cell["traffic"]
    h, w = traffic["frame_height"], traffic["frame_width"]
    rng = np.random.RandomState(seed % 2 ** 32)
    payloads = [rgb_to_i420(serving_frame(seed, int(i), h, w, traffic["focal_scale"]))
                for i in rng.randint(0, traffic["pool"], traffic["check_frames"])]
    P, S = load_artifact(os.path.join(common.ROOT, conf["serving"]["weights"]))
    cam, widths = serve.camera(conf, traffic), Widths.of(conf)
    ref = serve_check.candidates(widths, P, S, payloads, h, w, cam, conf["image_size"], card)
    ctl = serve_check.candidates(widths, P, S, payloads, h, w, cam, conf["image_size"], card, fp8=True)
    gaps = serve_check.judge([serve_check.answer_of(c) for c in ctl], ref)
    assert _broken(gaps, _limits(conf["name"])["serve"]), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["train-phi0-512-b16", "train-phi0-256-b16"])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_tf32_control_fails_training(card, workload, seed, tmp_path):
    from harness import synthetic, train
    from hmd_ego_pose_tpu_torch.ops.augment_device import draw_augment
    from reference import shapes, train_check
    from reference.model import Widths

    cell = common.cell(workload)
    conf, size = cell["config"], cell["config"]["image_size"]
    widths = Widths.of(conf)
    data = synthetic.generate_dataset(str(tmp_path), conf["train_split_frames"], size, seed)
    data["points"] = train.read_ply_points(os.path.join(str(tmp_path), "models", "obj_01.ply"))
    tdata = {k: torch.as_tensor(np.asarray(data[k]), device=card) for k in ("frames", "masks")}
    tdata.update({k: torch.as_tensor(np.asarray(data[k], np.float32), device=card)
                  for k in ("boxes", "rotvecs", "translations", "hands", "cameras", "points")})
    params, _ = shapes.draw(torch.Generator(device=card).manual_seed(seed), card, widths)
    g = torch.Generator().manual_seed(seed % 2 ** 32)
    steps = []
    n, b = data["frames"].shape[0], conf["training"]["batch_size"]
    for _ in range(train.CHECKED_STEPS):
        draws = draw_augment(g, b, size, size)
        steps.append({"idx": torch.randperm(n, generator=g)[:b].tolist(), "draws": train.draws_on(draws, card),
                      "drop": torch.rand((len(widths.blocks()), b), generator=g).to(card)})
    kw = {"lr": conf["training"]["learning_rate"], "hand_relative": conf["training"]["hand_relative"]}
    ref = train_check.follow(widths, params, tdata, steps, size, **kw)
    ctl = train_check.follow(widths, params, tdata, steps, size, tf32=True, **kw)
    gaps = train_check.compare(ctl, ref)
    assert _broken(gaps, _limits(conf["name"])["train"]), gaps
