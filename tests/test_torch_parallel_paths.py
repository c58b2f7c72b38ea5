"""Data-parallel training on the port's other paths, and ``cli train`` under
two gloo ranks on the CPU (phi-0, 128 px, 8-frame sets, from the shipped
artifact).

* The host pipeline (``device_augment=False``: augmented on the host from
  per-example seeds) and windows (a budget of four frames): at W = 2 each
  rank's batch rows equal the single-process batch's rows byte for byte;
  the multi-object set (``--object-ids 1,2``, the artifact widened to two
  classes) on the resident path with augmentation and drop-connect.  On
  every path the losses within 1e-5 relative of the single-process step's
  and the ranks bit-identical (one epoch at oversample 1: at most 2 steps).
* ``torchrun``'s launch of ``cli train`` as two gloo ranks, one epoch: only
  rank 0 writes checkpoints and metrics, the best checkpoint restores in
  both packages, and both ranks name it and end on the same plateau state.
"""

import os

import jax
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks_mod
from hmd_ego_pose_tpu.train import checkpoint as jax_checkpoint
from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
from hmd_ego_pose_tpu_torch.data.device_dataset import build_host_cache
from hmd_ego_pose_tpu_torch.models.weights import widen_classes
from hmd_ego_pose_tpu_torch.train import checkpoint

SIZE, BATCH = 128, 4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    base = tmp_path_factory.mktemp("dp_paths")
    one, two = str(base / "syn"), str(base / "syn2")
    cli.main(["make-synthetic", "--out-dir", one, "--num-frames", "8", "--frame-size", str(SIZE),
              "--hand-render-version", "3"])
    cli.main(["make-synthetic", "--out-dir", two, "--num-frames", "8", "--frame-size", str(SIZE),
              "--hand-render-version", "3", "--num-objects", "2"])
    params, bn_state, meta = checkpoint.restore_checkpoint(ranks_mod.ARTIFACT, device="cpu")
    widened = checkpoint.save_checkpoint(str(base), "widened", widen_classes(params, 2), bn_state,
                                         metadata={"hand_relative": meta["hand_relative"]})
    return {"one": one, "two": two, "widened": widened}


@pytest.fixture(scope="module")
def runs(sets, tmp_path_factory):
    base = {"kind": "steps", "size": SIZE, "batch": BATCH, "oversample": 1}
    per_frame = build_host_cache(ColibriDataset(sets["one"], 0, 1, "train"), 1).bytes_per_frame()
    named = {
        "host": {**base, "dataset": sets["one"], "augment": True, "data": {"device_augment": False}},
        "windowed": {**base, "dataset": sets["one"], "data": {"device_resident_budget_bytes": 4 * per_frame + 1}},
        "multi_object": {**base, "dataset": sets["two"], "ckpt": sets["widened"], "augment": True,
                         "drop_connect": True, "steps": 1, "flags": ["--object-ids", "1,2"]},
    }
    ranks = ranks_mod.run_ranks(2, list(named.values()), tmp_path_factory.mktemp("w2"))
    work = str(tmp_path_factory.mktemp("single"))
    return {name: (ranks_mod.steps_job(job, os.path.join(work, name)), [r[i] for r in ranks])
            for i, (name, job) in enumerate(named.items())}


@pytest.mark.parametrize("name, path", [("host", "host"), ("windowed", "windowed"), ("multi_object", "resident")])
def test_ranks_train_as_the_single_process_on_every_path(runs, name, path):
    single, ranks = runs[name]
    assert single["path"] == path and [r["path"] for r in ranks] == [path, path]
    assert 1 <= len(single["steps"]) <= 2 and len(ranks[0]["steps"]) == len(single["steps"])
    assert ranks[0]["digests"] == ranks[1]["digests"], "the ranks' parameters or BN buffers differ"
    for s, (got, want) in enumerate(zip(ranks[0]["steps"], single["steps"])):
        for term, v in want.items():
            assert got[term] == pytest.approx(v, rel=1e-5), (s, term)
    if name == "multi_object":
        return
    half = BATCH // 2
    for s, rows in enumerate(single["rows"]):
        for r, rank in enumerate(ranks):
            for field, value in rows.items():
                if value is None or value.ndim == 0:
                    continue
                mine = rank["rows"][s][field]
                assert mine.dtype == value.dtype and mine.tobytes() == value[r * half:(r + 1) * half].tobytes(), \
                    (s, r, field)


def test_cli_train_under_two_gloo_ranks(sets, tmp_path):
    argv = ["train", "--dataset-path", sets["one"], "--img-size", str(SIZE), "--batch-size", str(BATCH),
            "--epo", "1", "--ckpt", ranks_mod.ARTIFACT, "--device", "cpu"]
    ranks = [r[0] for r in ranks_mod.run_ranks(2, [{"kind": "cli", "argv": argv}], tmp_path)]
    zero, one = ranks
    assert zero["best"] == one["best"] and zero["best"].startswith("train_weights")
    assert zero["lr"] == one["lr"] and zero["plateau"] == one["plateau"]
    assert one["files"] == [], "only rank 0 writes checkpoints and metrics"
    assert os.path.join("train_weights", "last.npz") in zero["files"]
    assert any(f.startswith("runs") and f.endswith(".jsonl") for f in zero["files"])
    best = os.path.join(str(tmp_path), "rank0-job0", zero["best"])
    jp, jb, jmeta = jax_checkpoint.restore_checkpoint(best)
    tp, tb, tmeta = checkpoint.restore_checkpoint(best, device="cpu")
    assert jmeta == tmeta and jmeta["metric"] == pytest.approx(zero["plateau"]["best"])
    for a, b in zip(jax.tree.leaves((jp, jb)), jax.tree.leaves((tp, tb))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
