"""Every single-process training path through its step graph, on the CPU, against the eager path and JAX.

A CUDA graph exists only on a card (``chip_smoke.py`` holds each path's
graph bit-equal to its eager step there, with deterministic cuDNN).  Here
the stand-in capture of ``tests/test_torch_graphs.py`` (a replay runs the
captured function again; the host's optimizer count is not replayed) runs
the graphs' plumbing at phi-0, 128 px, batch 2, on 8-frame synthetic sets,
and each graphed epoch must equal the eager epoch of the same seed bit for
bit: the six means, every parameter and BN statistic, the optimizer's count
and the generator's state (the same draws in the same order):

* the windowed path (``ResidentGraph`` over the ``WindowBuffer``, one
  capture for every window), with the same windows;
* the host pipeline (``HostGraph``) with ``RawBatch`` (augmented on the
  device, in the graph) and ``Batch`` (augmented on the host) sources;
* two objects a frame with a symmetric object (object 2), whose loss is
  the fixed-shape minimum distance;
* Nesterov SGD (``fine_tune``) and remat of the backbone.

Besides: the fixed-shape symmetric transformation loss and its gradient
against the JAX package's ``transformation_loss`` (rtol 1e-5 on the losses,
1e-4 of the largest gradient on the gradient; tied minima share the
gradient evenly, as JAX's ``min``), with a chunk of the minimum distance
that does not divide the anchors; ``NesterovSGD`` against optax's
``sgd(nesterov=True)`` run op by op, bit for bit over three steps with a
learning-rate change, and ``leaves()`` / ``load_leaves()`` round trip.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hmd_ego_pose_tpu import losses as jax_losses
from hmd_ego_pose_tpu_torch import cli, losses
from hmd_ego_pose_tpu_torch.config import Config, DataConfig, LossConfig, ModelConfig, TrainConfig
from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
from hmd_ego_pose_tpu_torch.data.device_dataset import build_host_cache
from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose, init_weights
from hmd_ego_pose_tpu_torch.ops.augment_device import Batch, RawBatch
from hmd_ego_pose_tpu_torch.train.state import NesterovSGD, Optimizer
from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES, HostGraph, ResidentGraph, TrainStep
from hmd_ego_pose_tpu_torch.train.trainer import Trainer
from hmd_ego_pose_tpu_torch.utils import graphs
from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

SIZE, BATCH = 128, 2
POINTS = 60  # model points of the rotation loss (500 in the runs: a CPU test keeps it small)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    roots = {}
    for k in (1, 2):
        root = str(tmp_path_factory.mktemp(f"graph_paths{k}") / "syn")
        cli.main(["make-synthetic", "--out-dir", root, "--num-frames", "8", "--frame-size", str(SIZE),
                  "--hand-render-version", "3", "--num-objects", str(k)])
        roots[k] = root
    return roots


class _StepRerun(graphs.Graph):
    """A step's "graph" whose replay runs the captured step again; the host's
    side of the step (the optimizer's count) is not replayed, as a graph's
    replay runs no Python."""

    def __init__(self, fn):
        super().__init__(None, None, ())
        self.fn = fn

    def replay(self):
        optimizer = self.fn.__self__.step.optimizer
        count = optimizer.count
        self.fn()
        optimizer.count = count


def _step_capture(fn, device, pool=None, warmup=1):
    """A capture runs nothing: the warm-up calls run for real, the captured call is kept."""
    for _ in range(warmup):
        fn()
    return _StepRerun(fn)


def _trainer(root, k=1, model=None, train=None, **data):
    ids = [1, 2] if k == 2 else None
    cfg = Config(model=ModelConfig(image_size=SIZE, num_classes=k, **(model or {})),
                 train=TrainConfig(batch_size=BATCH, oversample=1, seed=3, checkpoint_dir="unused",
                                   loss=LossConfig(num_model_points=POINTS), **(train or {})),
                 data=DataConfig(max_objects=k, num_workers=1, **data))
    return Trainer(cfg, ColibriDataset(root, 0, 1, "train", object_ids=ids), None, device="cpu",
                   logger=MetricLogger(stdout=False))


def _state(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def _graphed_equals_eager(monkeypatch, make, graph_type, epochs=1):
    """``make()``'s trainer for ``epochs`` epochs eagerly and through the
    stand-in graph: every mean, tensor, count and generator state equal."""
    eager = make()
    want = [eager.train_epoch(e) for e in range(epochs)]
    with monkeypatch.context() as m:
        m.setattr(TrainStep, "graphable", property(lambda self: True))
        m.setattr(graphs, "capture", _step_capture)
        graphed = make()
        assert graphed.graphed and type(graphed.graph) is graph_type
        got = [graphed.train_epoch(e) for e in range(epochs)]
    for g, w in zip(got, want):
        assert g["steps"] == w["steps"] > 0
        assert {k: g[k] for k in METRIC_NAMES} == {k: w[k] for k in METRIC_NAMES}
    se, sg = _state(eager), _state(graphed)
    assert [k for k in se if not torch.equal(se[k], sg[k])] == []
    assert graphed.optimizer.count == eager.optimizer.count == sum(w["steps"] for w in want)
    assert eager.generator.get_state().equal(graphed.generator.get_state())
    return eager, graphed


# ---------------------------------------------------------------------------
# windows and the host pipeline
# ---------------------------------------------------------------------------


def test_windowed_epochs_through_one_graph_equal_the_eager_epochs(sets, monkeypatch):
    per_frame = build_host_cache(ColibriDataset(sets[1], 0, 1, "train"), 1).bytes_per_frame()

    def make():
        t = _trainer(sets[1], device_resident_budget_bytes=4 * per_frame + 100)
        assert t.path == "windowed" and t.window_frames == 4
        return t

    eager, graphed = _graphed_equals_eager(monkeypatch, make, ResidentGraph, epochs=2)
    assert graphed.windows == eager.windows and len(graphed.windows) >= 2  # a tail window among them
    assert graphed.graph.data is graphed.window.data is graphed.data  # one buffer for every window
    assert graphed.graph.steps == 4 // BATCH and graphed.graph._key[1]  # colour ops in the graph


@pytest.mark.parametrize("source", ["raw", "batch"])
def test_host_epoch_through_the_graph_equals_the_eager_epoch(sets, monkeypatch, source):
    data = {"device_resident": False} if source == "raw" else {"device_augment": False}
    eager, graphed = _graphed_equals_eager(monkeypatch, lambda: _trainer(sets[1], **data), HostGraph)
    assert graphed.path == eager.path == "host"
    assert graphed.graph._type is (RawBatch if source == "raw" else Batch)
    assert graphed.graph.done == len(graphed.train_dataset) // BATCH
    assert (graphed.graph.colour is not None) == (source == "raw")


# ---------------------------------------------------------------------------
# symmetric objects, SGD, remat
# ---------------------------------------------------------------------------


def test_two_objects_with_a_symmetric_one_through_the_graph_equal_eager(sets, monkeypatch):
    eager, graphed = _graphed_equals_eager(monkeypatch, lambda: _trainer(sets[2], k=2), ResidentGraph)
    assert graphed.step_fn.symmetric and graphed.config.data.max_objects == 2


@pytest.mark.parametrize("variant", ["sgd", "remat"])
def test_sgd_and_remat_epochs_through_the_graph_equal_eager(sets, monkeypatch, variant):
    kw = ({"train": {"fine_tune": True}} if variant == "sgd" else
          {"model": {"remat_backbone": True}, "train": {"freeze_backbone": False}})
    eager, graphed = _graphed_equals_eager(monkeypatch, lambda: _trainer(sets[1], **kw), ResidentGraph)
    if variant == "sgd":
        assert isinstance(graphed.optimizer.opt, NesterovSGD)
    else:  # the backbone trained, through the checkpointed blocks
        assert graphed.model.backbone_net.model.remat
        start = _trainer(sets[1], **kw).model.state_dict()
        moved = [k for k, v in graphed.model.state_dict().items() if not torch.equal(v, start[k])]
        assert any(k.startswith("backbone_net.model._blocks.") for k in moved)


def _jax_transformation_loss(gt, pred, state, points, cap):
    def one(g, p, s):
        return jax_losses.transformation_loss(g, p, s, points, cap)

    def total(p):
        rot, trans = jax.vmap(one)(jnp.asarray(gt), p, jnp.asarray(state))
        return jnp.sum(rot) + jnp.sum(trans), (rot, trans)

    (_, (rot, trans)), grad = jax.value_and_grad(total, has_aux=True)(jnp.asarray(pred))
    return np.asarray(rot), np.asarray(trans), np.asarray(grad)


@pytest.mark.parametrize("chunk", [5, 64])
def test_fixed_shape_symmetric_loss_matches_jax(monkeypatch, chunk):
    """Mixed ``is_sym`` over the capped slice (symmetric and not, positive and
    negative anchors), two classes, the second with every point twice (tied
    minima); ``chunk`` 5 does not divide the 2 x 16 anchors."""
    rng = np.random.default_rng(11)
    b, n, cap = 2, 40, 16
    state = np.where(rng.uniform(size=(b, n)) < 0.3, 1.0, np.where(rng.uniform(size=(b, n)) < 0.5, 0.0, -1.0))
    state = state.astype(np.float32)
    gt = np.zeros((b, n, 8), np.float32)
    gt[..., :3] = rng.uniform(-0.5, 0.5, (b, n, 3))
    gt[..., 3:6] = rng.normal(0, 50, (b, n, 3)) + [0, 0, 600]
    gt[..., 6] = rng.uniform(size=(b, n)) < 0.5
    gt[..., 7] = rng.integers(0, 2, (b, n))
    pred = np.concatenate([gt[..., :3] + rng.normal(0, 0.05, (b, n, 3)),
                           gt[..., 3:6] + rng.normal(0, 5, (b, n, 3))], axis=-1).astype(np.float32)
    half = rng.uniform(-50, 50, (15, 3))
    points = np.stack([rng.uniform(-50, 50, (30, 3)), np.concatenate([half, half])]).astype(np.float32)
    assert 0 < gt[..., 6].sum() < b * n
    want_rot, want_trans, want_grad = _jax_transformation_loss(gt, pred, state, points, cap)
    monkeypatch.setattr(losses, "MIN_DISTANCE_CHUNK", chunk)
    p = torch.from_numpy(pred).requires_grad_(True)
    rot, trans = losses.transformation_loss(torch.from_numpy(gt), p, torch.from_numpy(state),
                                            torch.from_numpy(points), cap)
    (rot.sum() + trans.sum()).backward()
    np.testing.assert_allclose(rot.detach().numpy(), want_rot, rtol=1e-5)
    np.testing.assert_allclose(trans.detach().numpy(), want_trans, rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), want_grad, rtol=0, atol=1e-4 * np.abs(want_grad).max())
    assert np.abs(want_grad[..., :3]).max() > 0  # the rotation's gradient is held, not only the translation's
    # no symmetric ground truth: skipping the minimum (``symmetric=False``) changes nothing
    plain = gt.copy()
    plain[..., 6] = 0.0
    args = (torch.from_numpy(plain), torch.from_numpy(pred), torch.from_numpy(state), torch.from_numpy(points), cap)
    for on, off in zip(losses.transformation_loss(*args), losses.transformation_loss(*args, symmetric=False)):
        assert torch.equal(on, off)


def test_nesterov_sgd_matches_optax_and_round_trips_its_leaves():
    rng = np.random.default_rng(2)
    params = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 5))]
    grads = [[rng.normal(0, 0.1, p.shape).astype(np.float32) for p in params] for _ in range(3)]
    rates = (3e-3, 3e-3, 1.5e-3)  # a plateau step before the third update
    tx = optax.inject_hyperparams(lambda learning_rate: optax.sgd(learning_rate, momentum=0.9, nesterov=True))(
        learning_rate=rates[0])
    jparams, opt_state = [jnp.asarray(p) for p in params], None
    opt_state = tx.init(jparams)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    lr = torch.tensor(rates[0], dtype=torch.float32)
    sgd = NesterovSGD(tparams, lr, 0.9)
    with jax.disable_jit():  # op by op, each rounded on its own
        for g, rate in zip(grads, rates):
            opt_state.hyperparams["learning_rate"] = jnp.asarray(rate, jnp.float32)
            updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jparams)
            jparams = optax.apply_updates(jparams, updates)
            lr.fill_(rate)
            for p, x in zip(tparams, g):
                p.grad = torch.from_numpy(x)
            sgd.step()
    for got, want in zip(tparams, jparams):  # tolerance 0: the same float32 operations
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    traces = jax.tree.leaves(opt_state)[2:]
    for p, want in zip(tparams, traces):
        np.testing.assert_array_equal(sgd.state[p]["momentum_buffer"].numpy(), np.asarray(want))

    # the optimizer's JAX-layout leaves: saved, loaded into another, the same state and the same next step
    def model():
        return init_weights(HMDEgoPose(ModelConfig(phi=0, image_size=SIZE)), torch.Generator().manual_seed(0))

    cfg = TrainConfig(fine_tune=True, learning_rate=2e-3)
    a, b = model(), model()
    oa, ob = Optimizer(a, cfg, a.config), Optimizer(b, cfg, b.config)
    step_grads = [torch.randn(p.shape, generator=torch.Generator().manual_seed(i)) * 0.01
                  for i, p in enumerate(oa.params)]
    for _ in range(2):
        for p, g in zip(oa.params, step_grads):
            p.grad = g.clone()
        oa.step()
    b.load_state_dict(a.state_dict())
    ob.load_leaves(oa.leaves())
    assert ob.count == oa.count == 2 and ob.learning_rate == oa.learning_rate
    for x, y in zip(oa.leaves(), ob.leaves()):
        np.testing.assert_array_equal(x, y)
    for o in (oa, ob):
        for p, g in zip(o.params, step_grads):
            p.grad = g.clone()
        o.step()
    assert all(torch.equal(x, y) for x, y in zip(oa.params, ob.params))


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graphed", [True, False], ids=["graph", "eager"])
def test_training_spans_name_each_step_and_the_epoch_edge(sets, monkeypatch, graphed):
    """Two resident epochs, the recorder on: each epoch's indices and loss
    read under the epoch's id, each step's draws (and through the graph its
    staging, the wait inside it and the capture or replay) under the step's."""
    from hmd_ego_pose_tpu_torch.utils.profiler import RECORDER

    if graphed:
        monkeypatch.setattr(TrainStep, "graphable", property(lambda self: True))
        monkeypatch.setattr(graphs, "capture", _step_capture)
    trainer = _trainer(sets[1])
    assert trainer.path == "resident" and trainer.graphed == graphed
    RECORDER.start()
    try:
        outs = [trainer.train_epoch(e) for e in range(2)]
    finally:
        spans = RECORDER.stop()
    epochs = [s for s in spans if s.name == "train.epoch"]
    steps = [s for s in spans if s.name == "train.step"]
    assert len(epochs) == 2 and len(steps) == sum(o["steps"] for o in outs) > 0
    for epoch in epochs:
        inside = sorted(s.name for s in spans if s.rid == epoch.rid and s is not epoch)
        assert inside == ["train.epoch_end", "train.indices"]
        assert all(s.parent == epoch.span_id for s in spans if s.rid == epoch.rid and s is not epoch)
        assert sum(epoch.start_ns <= s.start_ns <= epoch.end_ns for s in steps) == outs[0]["steps"]
    assert len({s.rid for s in steps}) == len(steps)
    want = ["train.draws", "train.replay", "train.stage", "train.stage_wait"] if graphed else ["train.draws"]
    for k, step in enumerate(steps):
        mine = {s.name: s for s in spans if s.rid == step.rid and s is not step}
        names = sorted(mine)
        if graphed and k == 0:  # the run's first step captures the graph
            assert names == sorted(["train.capture", "train.draws", "train.stage", "train.stage_wait"])
        else:
            assert names == want
        for name, s in mine.items():
            assert s.parent == (mine["train.stage"].span_id if name == "train.stage_wait" else step.span_id)
            assert step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns and s.thread == "MainThread"
