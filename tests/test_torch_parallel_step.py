"""Data-parallel train steps of the port: gloo ranks on the CPU against the
JAX package's mesh step and against the port's single-process step.

phi-0, 128 px, global batch 4, from the shipped artifact, on an 8-frame set;
each rank holds B / W rows (``tests/torch_dp_ranks.py`` runs the ranks).

* W = 2, augmentation and drop-connect off, one step, against JAX's
  ``make_train_step(device_data=True, mesh=make_mesh(ParallelConfig(),
  devices=jax.devices()[:2]))`` on the same rows (drop-connect off there
  too: its ``_compute_losses`` is given no key): the six loss terms within
  1e-4 relative, every parameter within 1e-4 of its leaf's largest value;
* W = 2 and W = 4 with augmentation and drop-connect on (two steps), and
  W = 2 with ``remat_backbone`` and ``--no-freeze-backbone`` (one step),
  against the port's single-process step of the same B rows: the loss terms
  within 1e-5 relative; the first step's averaged gradients within 1e-4 of
  the leaf's norm plus 1e-6 of the global norm G (as the single-card tests
  hold gradients: the BiFPN's fusion weights sum large terms that cancel,
  and their gradients differ by up to ~6e-5 of their norm between two
  summation orders); every parameter within 1e-5 of its leaf's largest
  value.

The data-parallel step through its graph (``train/step.py::ResidentGraph``
on a mesh; the stand-in capture of ``tests/torch_dp_ranks.py``: a replay
runs the step again, its collectives made but counted from the capture's
tally): at W = 2 the graphed augmented epoch (two steps, the second a
replay) equals the eager one bit for bit (means, losses, every parameter
and BN statistic, the optimizer's count), each replay's collective tally is
an eager step's by kind, and two fixed steps through the graph stay within
the JAX mesh step's tolerances above (the BN statistics after the second
within 1e-4 of the leaf's largest value).

Parameters whose first-step gradient is below rounding noise (|g| <= 1e-6 G:
the conv biases that feed a
training-mode BN and the like, whose exact gradient is zero) are held to
Adam's bound instead: Adam scales a gradient of any size, noise included,
to a step of about the learning rate, so they move by up to lr per step in
either direction in either run.  The parameters and BN buffers are
bit-identical across the ranks after every step (state digests).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks_mod
from hmd_ego_pose_tpu.config import Config as JaxConfig
from hmd_ego_pose_tpu.config import DataConfig as JaxDataConfig
from hmd_ego_pose_tpu.config import ModelConfig as JaxModelConfig
from hmd_ego_pose_tpu.config import ParallelConfig as JaxParallelConfig
from hmd_ego_pose_tpu.config import TrainConfig as JaxTrainConfig
from hmd_ego_pose_tpu.data.colibri import ColibriDataset as JaxColibriDataset
from hmd_ego_pose_tpu.data.device_dataset import build_host_cache, upload_window
from hmd_ego_pose_tpu.data.pipeline import InputPipeline as JaxInputPipeline
from hmd_ego_pose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hmd_ego_pose_tpu.train import checkpoint as jax_checkpoint
from hmd_ego_pose_tpu.train import step as jax_step
from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.config import ModelConfig
from hmd_ego_pose_tpu_torch.models.weights import to_jax_params
from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES

SIZE, BATCH, LR = 128, 4, 1e-4
TERMS = dict(zip(("loss", "classification_loss", "regression_loss", "rotation_loss", "translation_loss",
                  "hand_loss"), METRIC_NAMES))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp") / "syn")
    cli.main(["make-synthetic", "--out-dir", root, "--num-frames", "8", "--frame-size", str(SIZE),
              "--hand-render-version", "3"])
    return root


def jobs(dataset):
    base = {"kind": "steps", "dataset": dataset, "size": SIZE, "batch": BATCH}
    return {
        "fixed": {**base, "steps": 1},
        "augmented": {**base, "steps": 2, "augment": True, "drop_connect": True},
        "remat": {**base, "steps": 1, "drop_connect": True, "flags": ["--no-freeze-backbone"],
                  "model": {"remat_backbone": True}},
    }


def graph_jobs(named):
    """The W = 2 jobs through the step's graph: two fixed steps (held to JAX)
    and the augmented steps (held to the eager ones)."""
    return {"fixed_graph": {**named["fixed"], "steps": 2, "graph": True},
            "augmented_graph": {**named["augmented"], "graph": True}}


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
    """name -> (single-process result, [rank results]) at W = 2 (the graphed
    jobs without a single-process run), and the augmented run at W = 4."""
    named = jobs(dataset)
    graphed = graph_jobs(named)
    two = ranks_mod.run_ranks(2, list(named.values()) + list(graphed.values()), tmp_path_factory.mktemp("w2"))
    four = ranks_mod.run_ranks(4, [named["augmented"]], tmp_path_factory.mktemp("w4"))
    work = str(tmp_path_factory.mktemp("single"))
    single = {name: ranks_mod.steps_job(job, os.path.join(work, name)) for name, job in named.items()}
    out = {name: (single.get(name), [r[i] for r in two]) for i, name in enumerate([*named, *graphed])}
    out["augmented_w4"] = (single["augmented"], [r[0] for r in four])
    return out


def global_norm(grads) -> float:
    return float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values())))


def hold_params(got: dict, want: dict, grads: dict, g_norm: float, rel: float, noise: float, steps: int) -> None:
    """Every parameter within ``rel`` of its leaf's largest value; elements
    whose gradient is within ``noise`` G of zero within Adam's 2 steps lr."""
    off = {}
    for key, w in want.items():
        diff = np.abs(got[key] - w)
        bound = np.full(w.shape, rel * max(float(np.abs(w).max()), 1e-12), np.float32)
        if key in grads:
            bound = np.where(np.abs(grads[key]) <= noise * g_norm, 2 * steps * LR, bound)
        if not (diff <= bound).all():
            off[key] = (float(diff.max()), int((diff > bound).sum()))
    assert not off, off


@pytest.mark.parametrize("name", ["fixed", "augmented", "augmented_w4", "remat"])
def test_ranks_match_the_single_process_step(runs, name):
    single, ranks = runs[name]
    assert [r["path"] for r in ranks] == [single["path"]] * len(ranks) == ["resident"] * len(ranks)
    for r in ranks[1:]:
        assert r["digests"] == ranks[0]["digests"], "the ranks' parameters or BN buffers differ"
    assert len(ranks[0]["steps"]) == len(single["steps"])
    for s, (got, want) in enumerate(zip(ranks[0]["steps"], single["steps"])):
        for term, v in want.items():
            assert got[term] == pytest.approx(v, rel=1e-5), (s, term)
    g_norm = global_norm(single["grads"])
    for key, want in single["grads"].items():
        gap = np.linalg.norm(ranks[0]["grads"][key] - want)
        assert gap <= 1e-4 * np.linalg.norm(want) + 1e-6 * g_norm, key
    hold_params(ranks[0]["state"], single["state"], single["grads"], g_norm, rel=1e-5, noise=1e-6,
                steps=len(single["steps"]))


def test_collectives_per_step(runs):
    """One packed BN all-reduce per BN application (153, the frozen backbone's 48 among them),
    one for the gradients and one for the losses; the backward of every BN that
    carries a gradient all-reduces too."""
    _, ranks = runs["fixed"]
    calls = ranks[0]["collectives"]
    assert calls["bn"] == 153 and calls["grads"] == 1 and calls["metrics"] == 1
    assert calls["bn_backward"] == 153 - 48
    _, remat = runs["remat"]
    # remat recomputes each backbone block in the backward pass: its BNs reduce again
    assert remat[0]["collectives"]["bn"] > 153 and remat[0]["collectives"]["bn_backward"] > calls["bn_backward"]


@pytest.fixture(scope="module")
def jax_mesh_step(jax_mesh_steps):
    """One step of the JAX package's mesh train step over 2 CPU devices, on the
    rows of the port's first step, without drop-connect."""
    return jax_mesh_steps[0]


@pytest.fixture(scope="module")
def jax_mesh_steps(dataset, runs, monkeypatch_module):
    """Two steps of the JAX package's mesh train step over 2 CPU devices, on
    the rows of the port's first two steps, without drop-connect: (losses,
    params, bn_state) after each."""
    original = jax_step._compute_losses
    monkeypatch_module.setattr(jax_step, "_compute_losses",
                               lambda params, bn, batch, rng, *a: original(params, bn, batch, None, *a))
    params, bn_state, meta = jax_checkpoint.restore_checkpoint(ranks_mod.ARTIFACT)
    cfg = JaxConfig(model=JaxModelConfig(phi=0, image_size=SIZE, hand_relative=bool(meta["hand_relative"])),
                    train=JaxTrainConfig(batch_size=BATCH),
                    data=JaxDataConfig(dataset_path=dataset, use_6dof_augmentation=False,
                                       use_colorspace_augmentation=False, preload=False))
    ds = JaxColibriDataset(dataset, 0, 1, "train")
    mesh = jax_make_mesh(JaxParallelConfig(), devices=jax.devices()[:2])
    data = upload_window(build_host_cache(ds, 1), None, mesh)
    idxs = JaxInputPipeline(ds, cfg.data, cfg.model, BATCH, seed=cfg.train.seed).epoch_indices(
        cfg.train.oversample)[:2]
    step = jax_step.make_train_step(cfg, ds.model_points_for_loss(cfg.train.loss.num_model_points),
                                    device_data=True, mesh=mesh)
    repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    state = jax.device_put(step.init_state(params, bn_state), repl)
    out = []
    for idx in idxs:
        idx = jax.device_put(jnp.asarray(idx.astype(np.int32)),
                             jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data")))
        state, metrics = step.jitted(state, (data, idx), jax.device_put(jax.random.PRNGKey(0), repl))
        out.append(({k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, state.params),
                    jax.tree.map(np.asarray, state.bn_state)))
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def hold_to_jax(rank: dict, jax_steps, bn_leaf_rel: float = 0.0) -> None:
    """``rank``'s losses of every step within 1e-4 relative of the JAX mesh
    step's, its parameters (``rank["state"]``) after the last within 1e-4 of
    the leaf's largest value (Adam's bound below the gradient noise), its BN
    statistics within rtol 1e-4, atol 1e-6 (the one-step tolerances), or with
    ``bn_leaf_rel`` within that much of the leaf's largest value."""
    for s, (metrics, _, _) in enumerate(jax_steps):
        for name, term in TERMS.items():
            assert rank["steps"][s][term] == pytest.approx(metrics[name], rel=1e-4), (s, name)
    _, params, bn_state = jax_steps[-1]
    model_cfg = ModelConfig(phi=0, image_size=SIZE, hand_relative=True)
    state = {k: torch.from_numpy(v) for k, v in rank["state"].items()}
    got_params, got_bn = to_jax_params(state, model_cfg)
    # the gradients in the JAX layout; NaN for the frozen leaves (never below the noise)
    grads = {k: torch.from_numpy(rank["grads"][k]) if k in rank["grads"] else torch.full_like(v, np.nan)
             for k, v in state.items()}
    hold_params(flat(got_params), flat(params), flat(to_jax_params(grads, model_cfg)[0]),
                global_norm(rank["grads"]), rel=1e-4, noise=1e-6, steps=len(jax_steps))
    for g, w in zip(jax.tree.leaves(got_bn), jax.tree.leaves(bn_state)):
        if bn_leaf_rel:
            assert np.abs(g - w).max() <= bn_leaf_rel * np.abs(w).max()
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_two_ranks_match_the_jax_mesh_step(runs, jax_mesh_step):
    _, ranks = runs["fixed"]
    hold_to_jax(ranks[0], [jax_mesh_step])


def test_graphed_mesh_steps_match_the_jax_mesh_steps(runs, jax_mesh_steps):
    """Two fixed steps through the step's graph (the first the capture's
    warm-up, the second a replay): after the first, each rank within the
    one-step tolerances of JAX's first mesh step; after the second, its losses within
    1e-4 relative and its parameters within 1e-4 of the leaf's largest value
    of JAX's second step, as after one, and its BN statistics within 1e-4 of
    the leaf's largest value: the first step's parameter noise moves a
    statistic near zero by ~2e-6 in the second, past the one-step atol of
    1e-6."""
    _, ranks = runs["fixed_graph"]
    assert all(r["graphed"] for r in ranks) and ranks[0]["digests"] == ranks[1]["digests"]
    assert [r["count"] for r in ranks] == [2, 2]
    for rank in ranks:
        hold_to_jax({**rank, "state": rank["first_state"]}, jax_mesh_steps[:1])
        hold_to_jax(rank, jax_mesh_steps, bn_leaf_rel=1e-4)


def test_graphed_mesh_epoch_equals_the_eager_mesh_epoch(runs):
    """The augmented steps with drop-connect (the trainer's epoch code, one
    step an epoch) through the graph and eagerly, on each rank: the six
    means and losses of every step, every parameter and BN statistic after
    each step and at the end, and the optimizer's count, bit for bit."""
    (_, eager), (_, graphed) = runs["augmented"], runs["augmented_graph"]
    for e, g in zip(eager, graphed):
        assert g["graphed"] and not e["graphed"]
        assert len(g["means"]) == len(e["means"]) == 2
        assert g["means"] == e["means"] and g["steps"] == e["steps"]
        assert g["digests"] == e["digests"]
        assert [k for k in e["state"] if not np.array_equal(g["state"][k], e["state"][k])] == []
        assert g["count"] == e["count"] == 2


def test_graph_collectives_per_replay_are_the_eager_steps(runs):
    """A replay's tally is one eager step's collectives by kind (BN, its
    backward, the gradients, the losses), and a graphed epoch counts what the
    eager epoch counts."""
    _, fixed = runs["fixed"]
    one_step = fixed[0]["collectives"]
    assert sorted(one_step) == ["bn", "bn_backward", "grads", "metrics"]
    for name in ("fixed_graph", "augmented_graph"):
        for rank in runs[name][1]:
            assert rank["tally"] == one_step, name
    (_, eager), (_, graphed) = runs["augmented"], runs["augmented_graph"]
    assert [r["collectives"] for r in graphed] == [r["collectives"] for r in eager]
