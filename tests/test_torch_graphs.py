"""The port's compiled-program layer (CUDA graphs) on the CPU, against the JAX package.

A CUDA graph exists only on a card; the ``cuda`` twins of these tests are in
``tests/test_torch_cuda.py`` (graph against eager for the engine, two
batches in flight, and for the train step; ``LAUNCHES`` per replay; a failed
capture raises).  Here, at phi-0 and 128 or 256 px:

* the device preprocess with its constants built once per device: bit-equal
  to jitted JAX, and a second call builds none;
* drop-connect uniforms drawn ahead (``drop_connect_uniforms``): a step
  given them equals, bit for bit, the step that drew them from the
  generator;
* the plumbing of ``train/step.py::ResidentGraph``, of ``EvalForward`` and of
  the engine's graphs, with a stand-in capture whose replay runs the
  captured function again (and, for the engine and the eval forward, writes
  into the captured outputs, as a graph's replay overwrites its memory): a
  trainer's epoch through the graph, colour ops included, equals the eager
  epoch bit for bit (means, parameters, BN statistics, Adam's count, the
  generator's state); every batch of a small evaluation through the eval
  forward equals the eager predict, two validations of a trainer make one
  capture, a parameter replaced by a new tensor makes another, and on the
  CPU ``make_eval_forward`` captures nothing; the engine's replayed batches
  equal its eager ones, two batches in flight keep their own answers, a size
  without a graph runs eagerly and counts in ``eager_batches``;
* the engine on the CPU (no graph) against the JAX engine on the CPU: the
  poses within the goldens' bounds (one bf16 step of tz), ``stats()`` with
  exactly the JAX engine's keys, ``eager_batches`` 0;
* the kernel launch tally with a stub kernel library: a launch during a
  capture is recorded, not counted, and every replay counts it.
"""

import contextlib
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmd_ego_pose_tpu.config import ModelConfig as JaxModelConfig
from hmd_ego_pose_tpu.config import ServingConfig as JaxServingConfig
from hmd_ego_pose_tpu.ops.preprocess import preprocess_uint8_batch as jax_preprocess
from hmd_ego_pose_tpu.serving.engine import InferenceEngine as JaxEngine
from hmd_ego_pose_tpu.train import checkpoint as jax_checkpoint
from hmd_ego_pose_tpu_torch import cli, kernels
from hmd_ego_pose_tpu_torch.config import Config, EvalConfig, ModelConfig, ServingConfig, TrainConfig
from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
from hmd_ego_pose_tpu_torch.data.image import read_png
from hmd_ego_pose_tpu_torch.eval import golden as hold
from hmd_ego_pose_tpu_torch.eval.evaluator import evaluate_model
from hmd_ego_pose_tpu_torch.kernels import LAUNCHES, build
from hmd_ego_pose_tpu_torch.models.efficientnet import drop_connect_uniforms
from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose, init_weights
from hmd_ego_pose_tpu_torch.ops import preprocess
from hmd_ego_pose_tpu_torch.ops.augment_device import draw_augment
from hmd_ego_pose_tpu_torch.parallel.mesh import DataMesh
from hmd_ego_pose_tpu_torch.serving.engine import InferenceEngine
from hmd_ego_pose_tpu_torch.train import trainer as trainer_module
from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES, EvalForward, ResidentGraph, TrainStep, make_eval_forward
from hmd_ego_pose_tpu_torch.train.trainer import Trainer
from hmd_ego_pose_tpu_torch.utils import graphs
from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HANDREL = os.path.join(REPO, "trained", "syn1000_phi0_576ep_handrel_int8.npz")
GOLDEN = os.path.join(REPO, "tests", "goldens")
SIZE, BATCH = 128, 2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("graphs") / "syn")
    cli.main(["make-synthetic", "--out-dir", root, "--num-frames", "8", "--frame-size", str(SIZE),
              "--hand-render-version", "3"])
    return root


# ---------------------------------------------------------------------------
# stand-ins for a capture on the CPU
# ---------------------------------------------------------------------------


class _Rerun(graphs.Graph):
    """A "graph" whose replay calls the captured function again; with
    ``outputs``, it writes the new results into them, as a replay overwrites
    a graph's memory."""

    def __init__(self, fn, outputs, launches):
        super().__init__(None, outputs, launches)
        self.fn = fn

    def replay(self):
        new = self.fn()
        if self.outputs is not None:
            with torch.inference_mode():
                for old, value in zip(self.outputs, new):
                    old.copy_(value)
        for name in self.launches:
            LAUNCHES.add(name)


class _StepRerun(_Rerun):
    """A step's replay: the host's side of the step (Adam's count) is not
    replayed, as a graph's replay runs no Python."""

    def replay(self):
        optimizer = self.fn.__self__.step.optimizer
        count = optimizer.count
        super().replay()
        optimizer.count = count


def _step_capture(fn, device, pool=None, warmup=1):
    """A capture runs nothing: the warm-up calls run for real, the captured call is kept."""
    for _ in range(warmup):
        fn()
    return _StepRerun(fn, None, ())


def _engine_capture(fn, device, pool=None, warmup=1):
    for _ in range(warmup):
        fn()
    return _Rerun(fn, fn(), ())  # inference: running the captured call has no effect to undo


# ---------------------------------------------------------------------------
# preprocess: constants built once per device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(300, 300), (480, 640)])
def test_preprocess_with_cached_constants_bit_equal_to_jitted_jax(h, w):
    frames = np.random.default_rng(h + w).integers(0, 256, size=(2, h, w, 3), dtype=np.uint8)
    want = np.asarray(jax.jit(lambda f: jax_preprocess(f, 256))(jnp.asarray(frames)))
    x = torch.from_numpy(frames)
    first = preprocess.preprocess_uint8_batch(x, 256).numpy()
    built = preprocess._normalization.cache_info().misses
    second = preprocess.preprocess_uint8_batch(x, 256).numpy()
    assert preprocess._normalization.cache_info().misses == built  # the second call built no constant
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(second, want)
    constants = preprocess._normalization(torch.device("cpu"))
    assert constants is preprocess._normalization(torch.device("cpu"))


# ---------------------------------------------------------------------------
# drop-connect drawn ahead
# ---------------------------------------------------------------------------


def _trainer(dataset, **train):
    cfg = Config(model=ModelConfig(image_size=SIZE),
                 train=TrainConfig(batch_size=BATCH, oversample=1, seed=3, checkpoint_dir="unused", **train))
    return Trainer(cfg, ColibriDataset(dataset, 0, 1, "train"), None, device="cpu",
                   logger=MetricLogger(stdout=False))


def _state(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def test_drop_connect_drawn_ahead_equals_the_step_that_drew_it(dataset):
    a, b, c = (_trainer(dataset) for _ in range(3))
    idx = torch.tensor([0, 1])
    ga, gb, gc = (torch.Generator().manual_seed(11) for _ in range(3))
    blocks = len(a.model.backbone_net.model.specs)
    got = a.step_fn(a.data, idx, draw_augment(ga, BATCH, SIZE, SIZE), ga)
    draws = draw_augment(gb, BATCH, SIZE, SIZE)
    step = b.step_fn
    want = step.update(step.losses(step.prepare(b.data, idx, draws), drop=drop_connect_uniforms(gb, blocks, BATCH)))
    for k in METRIC_NAMES:
        assert torch.equal(got[k], want[k]), k
    sa, sb = _state(a), _state(b)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert ga.get_state().equal(gb.get_state())  # the same draws, in the same order
    # drop-connect really ran: without it the step differs
    off = c.step_fn(c.data, idx, draw_augment(gc, BATCH, SIZE, SIZE), None)
    assert not torch.equal(off["loss"], got["loss"])


# ---------------------------------------------------------------------------
# ResidentGraph's plumbing, replayed by re-running on the CPU
# ---------------------------------------------------------------------------


def test_graphable_only_on_a_card(dataset):
    t = _trainer(dataset)
    assert not t.step_fn.graphable and not t.graphed and t.graph is None
    assert not t.optimizer.capturable and isinstance(t.optimizer.opt.param_groups[0]["lr"], float)
    with pytest.raises(ValueError, match="cannot be captured"):
        ResidentGraph(t.step_fn, t.data, 3)
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.capture(lambda: None, torch.device("cpu"))
    sgd = _trainer(dataset, fine_tune=True)  # SGD's rate is a float32 tensor, filled in place
    lr = sgd.optimizer.opt.param_groups[0]["lr"]
    sgd.optimizer.set_learning_rate(5e-4)
    assert not sgd.graphed and lr is sgd.optimizer.opt.param_groups[0]["lr"] and lr.dtype == torch.float32
    assert float(lr) == np.float32(5e-4)
    # on a card (no card is touched to decide) one process captures whatever the
    # optimizer, objects and remat; a gloo mesh of several processes does not
    # (tests/test_torch_mesh_graphs.py has every mesh)
    cuda = torch.device("cuda")
    for model, train, symmetric in ((dict(remat_backbone=True), {}, False), ({}, dict(fine_tune=True), True),
                                    (dict(num_classes=2), {}, True)):
        config = Config(model=ModelConfig(image_size=SIZE, **model), train=TrainConfig(**train))
        card = SimpleNamespace(device=cuda, mesh=DataMesh(rank=0, world=1, device=cuda), config=config,
                               optimizer=SimpleNamespace(capturable=True), symmetric=symmetric)
        assert TrainStep.graphable.fget(card)
        gloo = DataMesh(rank=0, world=2, device=cuda, backend="gloo")
        assert not TrainStep.graphable.fget(SimpleNamespace(**{**vars(card), "mesh": gloo}))


def test_epoch_through_the_graph_equals_the_eager_epoch(dataset, monkeypatch):
    eager = _trainer(dataset)
    want = eager.train_epoch(0)
    monkeypatch.setattr(TrainStep, "graphable", property(lambda self: True))
    monkeypatch.setattr(graphs, "capture", _step_capture)
    graphed = _trainer(dataset)
    assert graphed.graphed and graphed.graph is not None
    assert graphed.config.data.use_colorspace_augmentation
    got = graphed.train_epoch(0)
    assert graphed.graph._key[1] and graphed.graph.colour is not None  # the colour ops ran in the graph
    assert got["steps"] == want["steps"] == graphed.graph.done == len(graphed.train_dataset) // BATCH
    assert {k: got[k] for k in METRIC_NAMES} == {k: want[k] for k in METRIC_NAMES}
    se, sg = _state(eager), _state(graphed)
    assert all(torch.equal(se[k], sg[k]) for k in se)
    assert graphed.optimizer.count == eager.optimizer.count == want["steps"]
    assert eager.generator.get_state().equal(graphed.generator.get_state())
    rows = graphed.graph.metrics
    assert int(graphed.graph.row) == want["steps"] and torch.isfinite(rows).all()
    # a second epoch writes from row 0 again; a step past the buffer raises
    assert graphed.train_epoch(1)["steps"] == want["steps"]
    with pytest.raises(RuntimeError, match="reset"):
        graphed.graph(torch.tensor([0, 1]), graphed.draws(), graphed.generator)
    graphed.graph.reset()
    with pytest.raises(ValueError, match="captured for"):  # no drop-connect: another graph
        graphed.graph(torch.tensor([0, 1]), graphed.draws(), None)


# ---------------------------------------------------------------------------
# EvalForward's plumbing, replayed by re-running on the CPU
# ---------------------------------------------------------------------------


def _eval_model(seed=0):
    cfg = Config(model=ModelConfig(image_size=SIZE), eval=EvalConfig(score_threshold=0.0, eval_batch_size=4))
    return init_weights(HMDEgoPose(cfg.model), torch.Generator().manual_seed(seed)), cfg


def _eval_batch(seed, b=4):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(b, SIZE, SIZE, 3)).astype(np.float32)
    cams = np.tile(np.array([480, 480, SIZE / 2, SIZE / 2, 1000, 1], np.float32), (b, 1))
    return images, cams


def _same(got, want):
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_eval_forward_equals_the_eager_predict_on_every_batch(dataset, monkeypatch):
    model, cfg = _eval_model()
    monkeypatch.setattr(graphs, "capture", _engine_capture)
    forward = EvalForward(model, cfg, torch.device("cpu"))
    calls = []

    def predict(images, cameras):
        got = forward(images, cameras)
        calls.append((got, forward.eager(images, cameras)))
        return got

    ds = ColibriDataset(dataset, 0, 1, "train")
    got = evaluate_model(ds, predict, cfg, "cpu")
    want = evaluate_model(ds, make_eval_forward(model, cfg, "cpu"), cfg, "cpu")
    assert len(calls) == -(-len(ds) // 4) >= 2 and forward.captures == 1
    for replayed, eager in calls:
        _same(replayed, eager)
        assert replayed.labels.dtype == np.int32 and replayed.boxes.shape == (4, cfg.eval.max_detections, 4)
    assert (calls[0][0].scores > 0).any()  # detections, not only padding
    assert got.scalars() == want.scalars()


def test_two_validations_make_one_capture(dataset, monkeypatch):
    monkeypatch.setattr(graphs, "capture", _engine_capture)
    monkeypatch.setattr(trainer_module, "make_eval_forward",
                        lambda model, config, device: EvalForward(model, config, device))
    cfg = Config(model=ModelConfig(image_size=SIZE), eval=EvalConfig(eval_batch_size=2),
                 train=TrainConfig(batch_size=BATCH, oversample=1, seed=3, checkpoint_dir="unused"))
    t = Trainer(cfg, ColibriDataset(dataset, 0, 1, "train"), ColibriDataset(dataset, 0, 1, "train"),
                device="cpu", logger=MetricLogger(stdout=False))
    first = t.validate(max_images=2)
    t.train_epoch(0)  # Adam and the BN statistics write in place: the graph's addresses hold
    second = t.validate(max_images=2)
    assert t.predict_fn.captures == 1
    assert first.scalars() != second.scalars() or first.num_matched == 0


def test_a_replaced_parameter_makes_a_new_capture(monkeypatch):
    model, cfg = _eval_model()
    monkeypatch.setattr(graphs, "capture", _engine_capture)
    forward = EvalForward(model, cfg, torch.device("cpu"))
    images, cams = _eval_batch(1)
    _same(forward(images, cams), forward.eager(images, cams))
    with torch.no_grad():
        model.load_state_dict({k: v * 1.01 for k, v in model.state_dict().items()})  # in place
    forward(images, cams)
    assert forward.captures == 1
    conv = model.classifier.header.pointwise_conv.conv
    conv.bias = torch.nn.Parameter(conv.bias.detach() + 1.0)  # a new tensor: the graph would read stale memory
    got = forward(images, cams)
    assert forward.captures == 2
    _same(got, forward.eager(images, cams))
    with pytest.raises(ValueError, match="captured at"):
        forward(*_eval_batch(2, b=2))


def test_make_eval_forward_on_the_cpu_captures_nothing(monkeypatch):
    def no_capture(*args, **kwargs):
        raise AssertionError("the CPU captures no graph")

    monkeypatch.setattr(graphs, "capture", no_capture)
    model, cfg = _eval_model()
    predict = make_eval_forward(model, cfg, "cpu")
    assert not isinstance(predict, EvalForward)
    images, cams = _eval_batch(3)
    det = predict(images, cams)
    want = EvalForward(model, cfg, torch.device("cpu")).eager(images, cams)
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(det, f)), getattr(want, f), err_msg=f)


def test_make_eval_forward_follows_the_models_mesh():
    """On a card, the model's own mesh decides: one process and a gloo data
    mesh of several processes capture (the predict makes no collective), so
    does an NCCL space axis (the graph holds its halos and gathers); a gloo
    space axis predicts eagerly (no card is touched to decide)."""
    model, cfg = _eval_model()
    assert isinstance(make_eval_forward(model, cfg, "cuda"), EvalForward)
    model.mesh = DataMesh(rank=0, world=2, device=torch.device("cuda"), backend="gloo")
    assert isinstance(make_eval_forward(model, cfg, "cuda"), EvalForward)
    model.mesh = DataMesh(rank=0, world=1, device=torch.device("cuda"), space=2, backend="nccl")
    assert isinstance(make_eval_forward(model, cfg, "cuda"), EvalForward)
    model.mesh = DataMesh(rank=0, world=1, device=torch.device("cuda"), space=2, backend="gloo")
    predict = make_eval_forward(model, cfg, "cuda")
    assert not isinstance(predict, EvalForward) and predict.__name__ == "eager"


# ---------------------------------------------------------------------------
# the engine's graphs, replayed by re-running on the CPU
# ---------------------------------------------------------------------------


def _random_engine(max_batch):
    cfg = ModelConfig(phi=0, image_size=SIZE)
    model = init_weights(HMDEgoPose(cfg), torch.Generator().manual_seed(0))
    return InferenceEngine(model, cfg, ServingConfig(max_batch_size=max_batch, score_threshold=0.0),
                           frame_shape=(SIZE, SIZE), device="cpu")


_host = InferenceEngine._to_host


def test_engine_replays_equal_eager_and_two_batches_in_flight_keep_their_answers(monkeypatch):
    engine = _random_engine(2)
    engine.warmup()
    assert engine.graphs == {} and engine.eager_batches == 0  # the CPU captures nothing
    monkeypatch.setattr(graphs, "capture", _engine_capture)
    monkeypatch.setattr(graphs, "pool_bytes", lambda pool, device: 0)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    engine.capture_mode = "batch"  # what a card in one process captures
    engine._capture()
    assert sorted(engine.graphs) == engine.batch_sizes == [1, 2]
    rng = np.random.default_rng(4)
    cams = np.tile(engine._default_camera()[None], (2, 1))
    a, b = (rng.integers(0, 256, size=(2, SIZE, SIZE, 3), dtype=np.uint8) for _ in range(2))

    def eager(frames):
        return _host(engine._predict(torch.from_numpy(frames), torch.from_numpy(cams[:len(frames)])))

    first = engine._dispatch_device(a, cams)
    second = engine._dispatch_device(b, cams)  # replays the same graph before the first is read
    for got, want in ((first, eager(a)), (second, eager(b))):
        for g, w in zip(_host(got), want):
            np.testing.assert_array_equal(g, w)
    assert not np.array_equal(_host(first)[1], _host(second)[1])
    for g, w in zip(_host(engine._dispatch_device(a[:1], cams[:1])), eager(a[:1])):
        np.testing.assert_array_equal(g, w)
    assert engine.eager_batches == 0
    three = np.concatenate([a, b[:1]])
    cams3 = np.tile(engine._default_camera()[None], (3, 1))
    engine._dispatch_device(three, cams3)  # no graph of 3 rows: eager, counted
    assert engine.eager_batches == 1
    assert set(engine.stats()) == {"queue", "device", "execute", "fetch", "total"}


# ---------------------------------------------------------------------------
# the engine on the CPU against the JAX engine on the CPU
# ---------------------------------------------------------------------------


def test_engine_on_the_cpu_answers_as_the_jax_engine():
    golden = dict(np.load(os.path.join(GOLDEN, "handrel_ckpt_expected.npz")).items())
    frames = [read_png(os.path.join(GOLDEN, f"handrel_ckpt_frame_{i}.png")) for i in (0, 3)]
    engine = cli.build_engine(HANDREL, "cpu", frame_size=256, max_batch_size=1, score_threshold=0.1)
    params, bn_state, _ = jax_checkpoint.restore_checkpoint(HANDREL)
    jax_engine = JaxEngine(params, bn_state,
                           JaxModelConfig(phi=0, image_size=256, compute_dtype="bfloat16", hand_relative=True),
                           JaxServingConfig(max_batch_size=1, score_threshold=0.1), frame_shape=(256, 256))
    jax_engine.warmup()
    engine.start()
    jax_engine.start()
    try:
        for i, frame in zip((0, 3), frames):
            got = engine.infer_blocking(frame, timeout=120)
            want = jax_engine.submit(frame).result(timeout=120)
            bnd = hold.bounds(golden, i, hand_relative=True)
            np.testing.assert_allclose(got[0], want[0], atol=bnd["rotation"])
            np.testing.assert_allclose(got[1], want[1], atol=bnd["translation"] / 1000.0)
    finally:
        engine.stop()
        jax_engine.stop()
    assert set(engine.stats()) == set(jax_engine.stats())
    assert engine.graphs == {} and engine.eager_batches == 0


# ---------------------------------------------------------------------------
# the launch tally
# ---------------------------------------------------------------------------


def test_launch_tally_records_captures_and_counts_replays(monkeypatch):
    calls, capturing = [], [False]

    class StubLibrary:
        def hegp_stub(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(build, "library", lambda name: StubLibrary())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    dev = torch.device("cuda")
    LAUNCHES.reset()
    kernels.launch("stub", "hegp_stub", dev, 1, 2)
    assert LAUNCHES.snapshot() == {"stub": 1} and calls == [(1, 2, 7)]
    capturing[0] = True
    with pytest.raises(RuntimeError, match="without a launch tally"):
        kernels.launch("stub", "hegp_stub", dev, 3)
    with kernels.recording() as tally:
        kernels.launch("stub", "hegp_stub", dev, 4)
        kernels.launch("stub", "hegp_stub", dev, 5)
        with pytest.raises(RuntimeError, match="already open"):
            with kernels.recording():
                pass
    assert tally == ["stub", "stub"] and LAUNCHES.get("stub") == 1  # recorded, not counted
    graph = graphs.Graph(SimpleNamespace(replay=lambda: None), None, tuple(tally))
    for _ in range(3):
        graph.replay()
    assert LAUNCHES.get("stub") == 1 + 3 * 2
    capturing[0] = False
    with kernels.recording() as empty:
        kernels.launch("stub", "hegp_stub", dev, 6)  # not capturing: counted at once
    assert empty == [] and LAUNCHES.get("stub") == 8
    LAUNCHES.reset()
