"""The plain reference against the program at phi 0 and 128 px, on the CPU
(phi 3: ``test_harness_widths.py``)."""

import numpy as np
import pytest
import torch

from harness import common
from reference import shapes
from reference.model import Net, Widths, anchors, load_artifact, preprocess

ARTIFACT = "trained/syn1000_phi0_576ep_handrel_int8.npz"
PHI0 = Widths.of(common.cell("serve-phi0-256-hmd")["config"])


def _program(image_size, P, S, dtype="float32"):
    from harness.train import nest
    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
    from hmd_ego_pose_tpu_torch.models.weights import from_jax_params

    cfg = ModelConfig(image_size=image_size, compute_dtype=dtype)
    model = HMDEgoPose(cfg)
    tensors = lambda d: {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}  # noqa: E731
    model.load_state_dict(from_jax_params(nest(tensors(P)), nest(tensors(S)), cfg), strict=True)
    return model.eval(), cfg


@pytest.fixture(scope="module")
def artifact():
    import os

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return load_artifact(os.path.join(root, ARTIFACT))


def test_the_tree_is_the_artifacts(artifact):
    P, S = artifact
    assert {k: tuple(v.shape) for k, v in P.items()} == dict(shapes.param_shapes(PHI0))
    assert set(S) == {f"{p}/{m}" for p in shapes.stat_names(PHI0) for m in ("mean", "var")}


def test_anchors_are_the_programs():
    from hmd_ego_pose_tpu_torch.ops.anchors import anchors_for_shape

    for size in (128, 256, 512):
        ours, theirs = anchors(size), anchors_for_shape((size, size))
        assert np.abs(ours[0] - theirs[0]).max() < 1e-3 and np.array_equal(ours[1], theirs[1])


def test_preprocess_agrees_with_the_programs():
    from hmd_ego_pose_tpu_torch.ops.preprocess import preprocess_uint8_batch

    frames = torch.randint(0, 256, (2, 72, 128, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    gap = (preprocess(frames, 128) - preprocess_uint8_batch(frames, 128)).abs()
    assert gap.max() <= 1.0 / 255 / 0.224 + 1e-5  # a resized pixel may round to the next level
    assert (gap > 1e-5).float().mean() < 0.01


def test_the_eval_forward_is_the_programs_in_float32(artifact):
    from hmd_ego_pose_tpu_torch.models import hmd_ego_pose

    P, S = artifact
    model, cfg = _program(128, P, S)
    x = torch.randn((2, 128, 128, 3), generator=torch.Generator().manual_seed(1))
    theirs = hmd_ego_pose.apply(model, x, cfg)
    ours = Net(PHI0, {k: torch.as_tensor(v) for k, v in P.items()},
               {k: torch.as_tensor(v) for k, v in S.items()}).forward(x)
    for name in ("regression", "classification", "rotation", "translation_raw", "hand"):
        a, b = ours[name], getattr(theirs, name)
        assert a.shape == b.shape, name
        assert (a - b).abs().max() <= 1e-3 * b.abs().max() + 1e-5, name


def test_the_float8_control_departs_further_than_bfloat16(artifact):
    from hmd_ego_pose_tpu_torch.models import hmd_ego_pose

    P, S = artifact
    x = torch.randn((2, 128, 128, 3), generator=torch.Generator().manual_seed(2))
    tensors = ({k: torch.as_tensor(v) for k, v in P.items()}, {k: torch.as_tensor(v) for k, v in S.items()})
    exact = Net(PHI0, *tensors).forward(x)["rotation"]
    fp8 = Net(PHI0, *tensors, fp8=True).forward(x)["rotation"]
    model, cfg = _program(128, P, S, "bfloat16")
    bf16 = hmd_ego_pose.apply(model, x, cfg).rotation
    assert (fp8 - exact).abs().mean() > 3 * (bf16 - exact).abs().mean()


def _candidates(n, best=0.99):
    rng = np.random.RandomState(3)
    return [{"score": np.array([best, best - 0.3, 0.1]), "rotation": rng.uniform(-1, 1, (3, 3)),
             "translation": rng.uniform(-0.2, 0.2, (3, 3)) + [0, 0, 0.5]} for _ in range(n)]


def test_the_judge_counts_every_dropped_answer_and_one_wrong_pose_in_ten():
    from reference import serve_check

    cands = _candidates(20)
    exact = [serve_check.answer_of(c) for c in cands]
    sound = serve_check.judge(exact, cands)
    assert sound["detection_misses"] == 0 and sound["pose_gap_mm.p90"] == 0
    dropped = serve_check.judge([None] + exact[1:], cands)
    assert dropped["detection_misses"] == 1 and dropped["pose_gap_mm"] == float("inf")
    moved = [(r, t + [0.05, 0, 0]) if i < 2 else (r, t) for i, (r, t) in enumerate(exact)]
    assert serve_check.judge(moved, cands)["pose_gap_mm.p90"] == pytest.approx(50.0)
    low = _candidates(20, best=0.45)
    assert serve_check.judge([serve_check.answer_of(c) for c in low], low)["detection_misses"] == 0
    assert serve_check.judge(exact, low)["detection_misses"] == 20  # a pose where the reference finds nothing
