"""EfficientPose phi 3 (EfficientNet-B3, a 160-filter BiFPN x6, five heads x4)
in the port, held beside phi 0 to the benchmark's plain float32 reference.

The reference is ``benchmark/reference/model.py`` (plain PyTorch: no JAX,
none of the port's kernels), with weights from ``reference/shapes.py``'s
seeded draw.  Everything runs on the CPU at 128 px and batch 2: the eval
forward, one training step's losses and first gradients (the port's
``Trainer`` on its eager CPU step, the reference through
``reference/train_check.py::follow`` from the same weights, frames, draws
and drop-connect uniforms, as the benchmark's training cells compare them),
the training-mode norm sites, and the anchor counts of the published input
sizes.  A step run in bfloat16 is held to fail the step's tolerances.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import arith, common, train  # noqa: E402
from reference import shapes  # noqa: E402
from reference.model import Net, Widths, anchors  # noqa: E402

WIDTHS = {0: {"phi": 0, "backbone": "efficientnet-b0", "fpn_num_filters": 64, "fpn_cell_repeats": 3,
              "head_repeats": 3},
          3: {"phi": 3, "backbone": "efficientnet-b3", "fpn_num_filters": 160, "fpn_cell_repeats": 6,
              "head_repeats": 4}}
OUTPUTS = ("regression", "classification", "rotation", "translation_raw", "hand")
SIZE, BATCH = 128, 2

# The eval forward: float32 on both sides, the same arithmetic in another
# order, so a gap is rounding.  The port's widest gap was 5.0e-7 to 1.0e-6
# of an output's largest value at phi 0 and 3; its bfloat16 forward's,
# 1.1e-4 to 6.7e-4.  The tolerance lies a decade from each, with 1e-6
# beside it for outputs near zero.
FORWARD_RTOL, FORWARD_ATOL = 1e-5, 1e-6
# One training step on the CPU, at 128 px and batch 2.  P7 is one pixel an
# image there, so its training-mode norms see two values a channel and
# magnify rounding (the float32 reference is as far from a float64 one as
# the port is).  Over 14 seeds the port's widest relative loss gap was
# 3.0e-5 at phi 0 and 1.2e-3 at phi 3 (the rotation loss), its worst leaf's
# first-gradient gap (``train_check.compare``'s ``grad_gap``) 1.4e-3 and
# 0.096 (0.165 on one other seed).  The same step in bfloat16 read 5.2e-2
# and 6.3e-2 and up, and 0.94 and 0.99 and up.
LOSS_RTOL = 1e-2
GRAD_GAP = 0.4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _conf(phi, **changes):
    conf = common.load_json(os.path.join(common.BENCH, "configs", "hmdegopose-phi0-256.json"))
    conf.update(WIDTHS[phi], image_size=SIZE, **changes)
    return conf


def _program(phi, params, stats):
    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
    from hmd_ego_pose_tpu_torch.models.weights import from_jax_params

    cfg = ModelConfig(phi=phi, image_size=SIZE)
    model = HMDEgoPose(cfg)
    model.load_state_dict(from_jax_params(train.nest(params), train.nest(stats), cfg), strict=True)
    return model.eval(), cfg


@pytest.mark.parametrize("phi", [0, 3])
def test_eval_forward_is_the_references_in_float32(phi):
    from hmd_ego_pose_tpu_torch.models import hmd_ego_pose

    widths = Widths.of(_conf(phi))
    params, stats = shapes.draw(torch.Generator().manual_seed(2 ** 31 + 41 + phi), "cpu", widths)
    g = torch.Generator().manual_seed(2 ** 31 + 42 + phi)  # running statistics other than the draw's 0 and 1
    stats = {k: (torch.rand(v.shape, generator=g) * 0.5 + 0.75 if k.endswith("/var")
                 else torch.randn(v.shape, generator=g) * 0.1) for k, v in stats.items()}
    model, cfg = _program(phi, params, stats)
    x = torch.randn((BATCH, SIZE, SIZE, 3), generator=torch.Generator().manual_seed(2 ** 31 + 43))
    with torch.no_grad():
        theirs = hmd_ego_pose.apply(model, x, cfg)
        ours = Net(widths, params, stats).forward(x)
    for name in OUTPUTS:
        a, b = ours[name], getattr(theirs, name)
        assert a.shape == b.shape, name
        assert (a - b).abs().max() <= FORWARD_RTOL * b.abs().max() + FORWARD_ATOL, name


def _step(phi, monkeypatch, dtype=None):
    """One step of the port's ``Trainer`` (eager, CPU; its model in ``dtype``
    where given) and the reference's from the same seed: (program losses,
    reference losses, gaps)."""
    import hmd_ego_pose_tpu_torch.config as config

    conf = _conf(phi, train_split_frames=5)  # 1 test, 2 val, 2 train frames: one step of 2 an epoch
    conf["training"].update(batch_size=BATCH, oversample=1)
    monkeypatch.setattr(train, "CHECKED_STEPS", 1)
    if dtype is not None:
        monkeypatch.setattr(config, "ModelConfig", functools.partial(config.ModelConfig, compute_dtype=dtype))
    out = train.run({"config": conf, "traffic": {"kind": "train"}}, 2 ** 31 + 1000 + phi, 0, False, device="cpu")
    program, reference = out["extra"]["readings"]["program"], out["extra"]["readings"]["reference"]
    assert len(program) == len(reference) == 1
    return np.array(program[0]), np.array(reference[0]), out["gaps"]


@pytest.mark.parametrize("phi", [0, 3])
def test_one_training_step_is_the_references(phi, monkeypatch):
    program, reference, gaps = _step(phi, monkeypatch)
    assert np.all(np.isfinite(program)) and np.all(reference > 0)
    assert np.all(np.abs(program - reference) <= LOSS_RTOL * reference), (program, reference)
    assert gaps["grad_gap"] <= GRAD_GAP, gaps


@pytest.mark.parametrize("phi", [0, 3])
def test_a_bfloat16_step_fails_the_steps_tolerances(phi, monkeypatch):
    program, reference, gaps = _step(phi, monkeypatch, "bfloat16")
    assert np.any(np.abs(program - reference) > LOSS_RTOL * reference), (program, reference)
    assert gaps["grad_gap"] > GRAD_GAP, gaps


@pytest.mark.parametrize("phi, count", [(0, 153), (3, 231)])
def test_the_training_norm_sites_are_the_references(phi, count):
    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose, apply_train
    from hmd_ego_pose_tpu_torch.nn.core import BatchNorm

    sites = common.metric_reader("batch_norm_roofline").norm_sites(Widths.of(_conf(phi)), SIZE)
    model = HMDEgoPose(ModelConfig(phi=phi, image_size=SIZE))
    seen = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(lambda mod, args, out: seen.append(tuple(args[0].shape)))
    with torch.no_grad():
        apply_train(model, torch.zeros((BATCH, SIZE, SIZE, 3)), model.config)
    assert len(sites) == len(seen) == count
    assert all(s[0] == BATCH for s in seen)
    assert sorted(int(np.prod(s[1:])) for s in seen) == sorted(values for _, values in sites)


@pytest.mark.parametrize("size, count", [(256, 12276), (512, 49104), (896, 150381)])
def test_anchor_counts_of_the_published_sizes(size, count):
    from hmd_ego_pose_tpu_torch.ops.anchors import anchors_for_shape

    boxes, translation = anchors_for_shape((size, size))
    ref_boxes, ref_translation = anchors(size)
    assert arith.num_anchors(size) == count == len(boxes) == len(ref_boxes)
    np.testing.assert_allclose(boxes, ref_boxes, rtol=0, atol=1e-3)
    np.testing.assert_allclose(translation, ref_translation, rtol=0, atol=1e-3)
