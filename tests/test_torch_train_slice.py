"""The slice end to end: ``cli train --device cpu`` of the shipped artifact.

An 8-frame synthetic set at 128 px (6 train frames, 1 val frame), batch 2,
one epoch (10x oversampled: 30 steps), from the int8 artifact.  The run
writes a best and a ``last`` checkpoint; the JAX package and the port both
restore both, with equal trees, and the JAX package rebuilds its optimizer
state from the port's ``opt/`` leaves.  Without ``--device cpu`` every
training entry point asks for the card and raises here.  The configurations
the port once refused (the host input pipeline, with ``device_augment`` or
``device_resident`` off; two objects; ``remat_backbone``) each train an
epoch, and ``cli train --object-ids 1,2`` trains a two-object set (8 frames,
6 train, 1 val) from the artifact widened to two classes.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from hmd_ego_pose_tpu.config import TrainConfig as JaxTrainConfig
from hmd_ego_pose_tpu.train import checkpoint as jax_checkpoint
from hmd_ego_pose_tpu.train.state import make_optimizer
from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
from hmd_ego_pose_tpu_torch.models.weights import widen_classes
from hmd_ego_pose_tpu_torch.train import checkpoint
from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES
from hmd_ego_pose_tpu_torch.train.trainer import Trainer
from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "trained", "syn1000_phi0_576ep_handrel_int8.npz")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slice") / "syn")
    cli.main(["make-synthetic", "--out-dir", root, "--num-frames", "8", "--frame-size", "128",
              "--hand-render-version", "3"])
    return root


def _train_args(dataset, *extra):
    return ["train", "--dataset-path", dataset, "--ckpt", ARTIFACT, "--img-size", "128", "--batch-size", "2",
            "--epo", "1", *extra]


def test_cli_train_on_the_cpu_writes_checkpoints_both_packages_restore(dataset, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    best = cli.main(_train_args(dataset, "--device", "cpu"))
    out = capsys.readouterr().out
    assert "checkpoint metadata records hand_relative=True" in out and "HMD-EgoPose parameter count" in out
    last = os.path.join("train_weights", "last.npz")
    assert best and os.path.exists(best) and os.path.exists(last)
    with open(last[:-4] + ".json") as f:
        meta = json.load(f)
    # the step count continues the artifact's (48,000); its optimizer starts fresh
    assert meta["train_step"] == 48_030 and meta["hand_relative"] is True and meta["epoch"] == 0
    with open(best[:-4] + ".json") as f:
        assert set(json.load(f)) == {"epoch", "metric", "hand_relative", "config", "metrics"}
    for path in (best, last):
        jp, jb, jmeta = jax_checkpoint.restore_checkpoint(path)
        tp, tb, tmeta = checkpoint.restore_checkpoint(path, device="cpu")
        assert jmeta == tmeta
        for jtree, ttree in ((jp, tp), (jb, tb)):
            jl, jdef = jax.tree_util.tree_flatten(jtree)
            tl, tdef = jax.tree_util.tree_flatten(ttree, is_leaf=lambda x: isinstance(x, torch.Tensor))
            assert jdef == tdef
            for a, b in zip(jl, tl):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the JAX trainer's resume: its optimizer's treedef over the port's leaves
    leaves = jax_checkpoint.restore_opt_leaves(last)
    t_leaves = jax.tree.leaves(make_optimizer(JaxTrainConfig(), jp).init(jp))
    assert len(leaves) == len(t_leaves)
    assert all(np.asarray(a).shape == t.shape and np.asarray(a).dtype == t.dtype for a, t in zip(leaves, t_leaves))
    assert int(leaves[0]) == 30 and int(leaves[6]) == 30
    with open(os.path.join("runs", sorted(f for f in os.listdir("runs") if f.endswith(".jsonl"))[0])) as f:
        records = [json.loads(line) for line in f]
    assert records[0]["steps"] == 30 and np.isfinite(records[0]["loss"])
    assert "val/mixed_point_distance_mean_mm" in records[1]


def test_training_needs_the_card_unless_asked_for_the_cpu(dataset, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_train_args(dataset))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Config(model=ModelConfig(image_size=128)), None, None)
    assert not os.path.exists("train_weights")


@pytest.fixture(scope="module")
def two_object_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slice2") / "syn")
    cli.main(["make-synthetic", "--out-dir", root, "--num-frames", "8", "--frame-size", "128",
              "--hand-render-version", "3", "--num-objects", "2"])
    return root


@pytest.mark.parametrize("change,path", [
    ({"data": DataConfig(device_augment=False)}, "host"),
    ({"data": DataConfig(device_resident=False)}, "host"),
    ({"data": DataConfig(max_objects=2), "model": ModelConfig(image_size=128, num_classes=2)}, "resident"),
    ({"model": ModelConfig(image_size=128, remat_backbone=True)}, "resident"),
])
def test_features_once_refused_now_train(change, path, dataset, two_object_set):
    """The configurations the port refused before it had the host pipeline,
    multi-object scenes and remat: each trains an epoch on the CPU."""
    model = change.get("model", ModelConfig(image_size=128))
    data = dataclasses.replace(change.get("data", DataConfig()), num_workers=2)
    two = data.max_objects == 2
    train_ds = ColibriDataset(two_object_set if two else dataset, 0, 1, "train", object_ids=[1, 2] if two else None)
    cfg = Config(model=model, data=data,
                 train=TrainConfig(batch_size=2, oversample=1, freeze_backbone=not model.remat_backbone))
    trainer = Trainer(cfg, train_ds, None, device="cpu", logger=MetricLogger(stdout=False))
    assert trainer.path == path
    metrics = trainer.train_epoch(0)
    assert metrics["steps"] == len(train_ds) // 2
    assert all(np.isfinite(metrics[k]) for k in METRIC_NAMES)


def test_cli_trains_more_than_one_object(two_object_set, tmp_path, monkeypatch):
    """``cli train --object-ids 1,2`` of the widened artifact: two classes, two
    ground-truth rows per frame, validation per class, both checkpoints."""
    monkeypatch.chdir(tmp_path)
    params, bn_state, meta = checkpoint.restore_checkpoint(ARTIFACT, device="cpu")
    start = checkpoint.save_checkpoint(str(tmp_path), "widened", widen_classes(params, 2), bn_state,
                                       metadata={"hand_relative": meta["hand_relative"]})
    args = cli.build_parser().parse_args(["train", "--dataset-path", two_object_set, "--ckpt", start,
                                          "--img-size", "128", "--batch-size", "2", "--epo", "1",
                                          "--object-ids", "1,2", "--device", "cpu"])
    trainer = cli.build_trainer(args, oversample=1)
    assert trainer.config.model.num_classes == 2 and trainer.config.data.max_objects == 2
    results = []
    best = trainer.fit(on_epoch_end=lambda e, m, r: results.append((m, r)))
    metrics, result = results[0]
    assert metrics["steps"] == len(trainer.train_dataset) // 2 and np.isfinite(metrics["loss"])
    assert sorted(result.per_class) == [0, 1]
    assert os.path.exists(os.path.join("train_weights", "last.npz")) and (best is None or os.path.exists(best))
    p, _, _ = checkpoint.restore_checkpoint(os.path.join("train_weights", "last.npz"), device="cpu")
    assert tuple(p["classifier"]["header"]["pointwise"]["bias"].shape) == (18,)
