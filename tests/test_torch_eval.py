"""The port's evaluator and ``cli evaluate`` against the JAX package.

* ``evaluate_model`` with a stub predictor (the ground truth plus seeded
  noise, false positives and low scores), on a one-object and a two-object
  synthetic set: every scalar equal to the JAX package's within 1e-6
  relative, and the ADD-S fields within 1e-4 mm (the port's ADD-S is float32
  on the device, the JAX package's on the CPU is a float64 loop).
* End to end: the shipped handrel artifact, fp32 and unfolded, through the
  port's ``cli make-synthetic`` and ``cli evaluate --device cpu`` and through
  the JAX package's ``evaluate_model``, on the val frames of a 24-frame v3
  set at 256 px.  Scalars within the tolerances ``chip_smoke.py`` holds the
  card to: counts equal, accuracies within 0.005, millimetres within 0.05,
  degrees within 0.01.
* Without a device the evaluation runs on the card, and raises without one.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

import chip_smoke
from hmd_ego_pose_tpu.config import Config as JaxConfig
from hmd_ego_pose_tpu.config import EvalConfig as JaxEvalConfig
from hmd_ego_pose_tpu.config import ModelConfig as JaxModelConfig
from hmd_ego_pose_tpu.data import colibri as jax_colibri
from hmd_ego_pose_tpu.eval import evaluator as jax_evaluator
from hmd_ego_pose_tpu.train.checkpoint import restore_checkpoint as jax_restore
from hmd_ego_pose_tpu.train.step import make_eval_forward
from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.config import Config, EvalConfig, ModelConfig
from hmd_ego_pose_tpu_torch.data import colibri
from hmd_ego_pose_tpu_torch.eval import evaluator, metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "trained", "syn1000_phi0_576ep_handrel_int8.npz")
ADD_S_FIELDS = {"sym_point_distance_mean_mm", "sym_point_distance_std_mm"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """Two 24-frame synthetic sets written by the port's CLI: {name: (root, object_ids)}."""
    out = {}
    for name, extra, ids in (("one", [], None), ("two", ["--num-objects", "2"], [1, 2])):
        root = str(tmp_path_factory.mktemp(name) / "syn")
        cli.main(["make-synthetic", "--out-dir", root, "--num-frames", "24", "--frame-size", "256",
                  "--hand-render-version", "3", *extra])
        out[name] = (root, ids)
    return out


class StubPredictor:
    """Per-chunk detections made from the annotations with seeded noise; both
    evaluators call it chunk by chunk, in frame order."""

    def __init__(self, dataset, batch, seed, k=6):
        rng = np.random.default_rng(seed)
        self.frames, self.batch, self.calls = [], batch, 0
        for i in range(len(dataset)):
            anno = dataset.load_annotations(i)
            det = {"boxes": np.zeros((k, 4), np.float32), "scores": -np.ones(k, np.float32),
                   "labels": -np.ones(k, np.int32), "rotation": np.zeros((k, 3), np.float32),
                   "translation": np.zeros((k, 3), np.float32), "hand": np.zeros((k, 63), np.float32)}
            n = 0
            for r in range(len(anno["labels"])):
                if rng.uniform() < 0.15:
                    continue  # a missed object
                det["boxes"][n] = anno["bboxes"][r] + rng.normal(scale=2.0, size=4)
                det["scores"][n] = rng.uniform(0.55, 1.0)
                det["labels"][n] = anno["labels"][r]
                det["rotation"][n] = (anno["rotations"][r, :3] + rng.normal(scale=0.03, size=3)) / np.pi
                det["translation"][n] = anno["translations"][r] + rng.normal(scale=10.0, size=3)
                det["hand"][n] = (anno["coords_3d"][r] + rng.normal(scale=0.02, size=(21, 3))).reshape(-1)
                n += 1
            for score in (rng.uniform(0.5, 0.9), 0.3):  # a false positive and one below the threshold
                x, y = rng.uniform(0, 200, size=2)
                det["boxes"][n] = [x, y, x + 40, y + 30]
                det["scores"][n] = score
                det["labels"][n] = rng.integers(0, len(dataset.class_to_name))
                det["translation"][n] = [0.0, 0.0, 500.0]
                n += 1
            self.frames.append(det)

    def _chunk(self):
        start = self.calls * self.batch
        self.calls += 1
        rows = [self.frames[min(start + j, len(self.frames) - 1)] for j in range(self.batch)]
        return types.SimpleNamespace(**{f: np.stack([r[f] for r in rows]) for f in rows[0]})

    def torch_fn(self, images, cams):
        assert images.shape[0] == cams.shape[0] == self.batch
        return self._chunk()

    def jax_fn(self, params, state, images, cams):
        return self._chunk()


def _assert_scalars_close(got, want, rel=1e-6, add_s_mm=1e-4):
    assert set(got) == set(want)
    for name, w in want.items():
        tol = add_s_mm if name in ADD_S_FIELDS else rel * max(abs(w), 1.0)
        assert abs(got[name] - w) <= tol, (name, got[name], w)


@pytest.mark.parametrize("name,partition,batch", [("one", "train", 5), ("one", "val", 8), ("two", "train", 3)])
def test_evaluate_model_with_a_stub_matches_jax(sets, name, partition, batch):
    root, ids = sets[name]
    k = len(ids) if ids else 1
    jds = jax_colibri.ColibriDataset(root, 0, 1, partition, object_ids=ids)
    tds = colibri.ColibriDataset(root, 0, 1, partition, object_ids=ids)
    jcfg = JaxConfig(model=JaxModelConfig(num_classes=k), eval=JaxEvalConfig(eval_batch_size=batch))
    tcfg = Config(model=ModelConfig(num_classes=k), eval=EvalConfig(eval_batch_size=batch))
    want = jax_evaluator.evaluate_model(jds, StubPredictor(jds, batch, seed=k).jax_fn, None, None, jcfg)
    got = evaluator.evaluate_model(tds, StubPredictor(tds, batch, seed=k).torch_fn, tcfg, "cpu")
    _assert_scalars_close(got.scalars(), want.scalars())
    assert sorted(got.per_class) == sorted(want.per_class) == list(range(k))
    for c in want.per_class:
        _assert_scalars_close(got.per_class[c].scalars(), want.per_class[c].scalars())
    assert 0 < got.num_matched <= len(tds) * k
    assert evaluator.format_report(got).splitlines()[0].startswith("mAP: ")


def test_format_report_and_aggregation_equal_jax():
    rng = np.random.default_rng(0)
    fields = {f.name: float(rng.uniform(0, 50)) for f in dataclasses.fields(evaluator.EvalResult)
              if f.name not in ("per_class", "num_matched")}
    got = evaluator.EvalResult(num_matched=7, **fields)
    want = jax_evaluator.EvalResult(num_matched=7, **fields)
    assert evaluator.format_report(got) == jax_evaluator.format_report(want)
    assert len(evaluator.format_report(got).splitlines()) == 23
    per_class_t = {0: (got, 3), 1: (evaluator.EvalResult(num_matched=2, **fields), 2), 2: (evaluator.EvalResult(), 0)}
    per_class_j = {0: (want, 3), 1: (jax_evaluator.EvalResult(num_matched=2, **fields), 2),
                   2: (jax_evaluator.EvalResult(), 0)}
    assert evaluator._aggregate_classes(per_class_t).scalars() == jax_evaluator._aggregate_classes(per_class_j).scalars()


def test_cli_evaluate_of_the_shipped_artifact_matches_jax_end_to_end(sets, capsys):
    root, _ = sets["one"]
    got = cli.main(["evaluate", "--dataset-path", root, "--ckpt", ARTIFACT, "--partition", "val",
                    "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "TranslationErrorHandMean_in_mm" in printed and '"num_matched"' in printed

    params, bn_state, meta = jax_restore(ARTIFACT)
    assert meta["hand_relative"] is True
    jcfg = JaxConfig(model=JaxModelConfig(phi=0, image_size=256, hand_relative=True))
    want = jax_evaluator.evaluate_model(jax_colibri.ColibriDataset(root, 0, 1, "val"),
                                        make_eval_forward(jcfg, score_threshold=0.5), params, bn_state, jcfg)
    assert want.num_matched > 0
    for name, w in want.scalars().items():
        tol = chip_smoke.EVAL_TOLERANCES[chip_smoke.scalar_kind(name)]
        assert abs(got.scalars()[name] - w) <= tol, (name, got.scalars()[name], w)


def test_cli_evaluate_refuses_what_is_not_ported(sets):
    """``--save-images-path`` and ``--iter`` are ported (tests/test_torch_cli_rest.py);
    the JAX flags that no evaluation reads are not flags of the port."""
    root, _ = sets["one"]
    base = ["evaluate", "--dataset-path", root, "--ckpt", ARTIFACT, "--device", "cpu"]
    args = cli.build_parser().parse_args(base + ["--save-images-path", "overlays", "--iter", "1"])
    assert (args.save_images_path, args.iter) == ("overlays", 1)
    with pytest.raises(SystemExit):  # read by no evaluation: not flags of the port
        cli.main(base + ["--dataset", "real_colibri"])
    with pytest.raises(SystemExit):
        cli.main(base + ["--batch-size", "1"])


def test_evaluation_defaults_to_the_card(sets, monkeypatch):
    """With no device, ADD-S runs on the card: without one it raises, never
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, _ = sets["one"]
    tds = colibri.ColibriDataset(root, 0, 1, "val")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluator.evaluate_model(tds, StubPredictor(tds, 8, seed=1).torch_fn, Config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        metrics.add_s_batch(np.zeros((10, 3)), 1.0, [])
