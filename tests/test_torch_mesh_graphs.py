"""The mesh's CUDA graphs on the CPU: which meshes are graphed, the
collective tally, and the engine's graphs on a data mesh.

A CUDA graph exists only on a card (``chip_smoke.py``'s ``mesh_graph`` phase
captures a step and the engine with their NCCL collectives on a one-rank
NCCL group, ``tests/test_torch_cuda.py`` captures each collective).  The two
gloo ranks that step through the graph against the eager step and JAX's
mesh step are in ``tests/test_torch_parallel_step.py``, on the ranks that
file already starts.  Here, without ranks:

* the truth table of ``DataMesh.capturable``, ``TrainStep.graphable``,
  ``make_eval_forward`` and the engine's ``capture_mode``: one process, an
  NCCL mesh with a card per rank (data, data x model, space, data x space)
  graphed, gloo not; predicts graphed on every mesh without a space axis
  and on an NCCL one with it, eager on a gloo space axis; ``make_mesh``
  over stand-in process groups records the backend;
* the collective tally: a collective made while the stream captures goes
  into the open tally, also from another thread (autograd's backward),
  never into the stats; a capture without a tally raises; each replay adds
  the tally's calls, and no seconds;
* a capture that raises on a capturable mesh is not swallowed: the trainer's
  step and the engine's warm-up raise, nothing steps eagerly;
* the engine on a two-process data mesh run as two threads (the mesh's
  broadcasts and gather between them), with the stand-in capture: process 0
  serves, process 1 follows, both captured by their warm-up; whole-batch
  graphs ("batch", an NCCL mesh) and graphs of a process's rows with eager
  broadcasts and gather ("rows", gloo) answer as the eager mesh engine and
  as one process predicting each row, bit for bit.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.config import Config, ModelConfig, ParallelConfig, ServingConfig, TrainConfig
from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose, init_weights
from hmd_ego_pose_tpu_torch.parallel import mesh as mesh_mod
from hmd_ego_pose_tpu_torch.parallel.mesh import LOCAL, DataMesh, make_mesh
from hmd_ego_pose_tpu_torch.serving import engine as engine_mod
from hmd_ego_pose_tpu_torch.serving.engine import InferenceEngine
from hmd_ego_pose_tpu_torch.train.step import EvalForward, TrainStep, make_eval_forward
from hmd_ego_pose_tpu_torch.train.trainer import Trainer
from hmd_ego_pose_tpu_torch.utils import graphs
from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

SIZE = 128
CUDA = torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# which meshes are graphed
# ---------------------------------------------------------------------------

MESHES = {  # name -> (mesh, step graphed, predict graphed, engine capture_mode)
    "local": (DataMesh(rank=0, world=1, device=CUDA), True, True, "batch"),
    "nccl_data": (DataMesh(rank=1, world=2, device=CUDA, process_rank=1, backend="nccl"), True, True, "batch"),
    "nccl_data_model": (DataMesh(rank=0, world=2, device=CUDA, model=2, model_rank=1, process_rank=1,
                                 backend="nccl"), True, True, "batch"),
    "gloo_data": (DataMesh(rank=1, world=2, device=CUDA, process_rank=1, backend="gloo"), False, True, "rows"),
    "nccl_space": (DataMesh(rank=0, world=1, device=CUDA, space=2, space_rank=1, process_rank=1,
                            backend="nccl"), True, True, "batch"),
    "nccl_data_space": (DataMesh(rank=1, world=2, device=CUDA, space=2, space_rank=1, process_rank=3,
                                 backend="nccl"), True, True, "batch"),
    "gloo_space": (DataMesh(rank=0, world=2, device=CUDA, space=2, process_rank=2, backend="gloo"),
                   False, False, None),
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_which_meshes_are_graphed(name):
    """No card is touched to decide: a graph holds the collectives of one
    process or of NCCL ranks with a card each, along any axes (the space
    axis's halos too); a predict is graphed on a card on every mesh without
    a space axis (it makes no collective) and on a capturable one."""
    mesh, step_graphed, predict_graphed, mode = MESHES[name]
    assert mesh.capturable == step_graphed
    step = SimpleNamespace(device=CUDA, mesh=mesh, optimizer=SimpleNamespace(capturable=True))
    assert TrainStep.graphable.fget(step) == step_graphed
    model = SimpleNamespace(mesh=mesh)
    assert isinstance(make_eval_forward(model, Config(), CUDA), EvalForward) == predict_graphed
    assert not isinstance(make_eval_forward(model, Config(), "cpu"), EvalForward)
    assert InferenceEngine._capture_mode(SimpleNamespace(device=CUDA, mesh=mesh)) == mode
    assert InferenceEngine._capture_mode(SimpleNamespace(device=torch.device("cpu"), mesh=mesh)) is None


@pytest.mark.parametrize("backend, layout, capturable", [
    ("nccl", (2, 1, 1), True), ("nccl", (1, 2, 1), True), ("nccl", (2, 1, 2), True), ("nccl", (1, 1, 2), True),
    ("gloo", (2, 1, 1), False), ("gloo", (1, 1, 2), False),
])
def test_make_mesh_records_the_groups_backend(monkeypatch, backend, layout, capturable):
    """``make_mesh`` under a stand-in process group (no card, no group): the
    mesh keeps the group's backend, which decides ``capturable``."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(dist, "new_group", lambda ranks: tuple(ranks))  # a stand-in group: its members
    data, model, space = layout
    n = data * model * space
    for rank in range(n):
        mesh = make_mesh(ParallelConfig(data_parallel=data, model_parallel=model, spatial_parallel=space),
                         world=n, rank=rank, device=torch.device("cuda", rank))
        assert mesh.backend == backend and mesh.capturable == capturable
    assert make_mesh(world=1, rank=0).capturable  # one process, whatever the group


# ---------------------------------------------------------------------------
# the collective tally
# ---------------------------------------------------------------------------


def test_collectives_under_capture_go_into_the_tally_and_each_replay_counts_them(monkeypatch):
    mesh = DataMesh(rank=0, world=2, device=CUDA, backend="nccl")
    made = []

    def collective(name):
        made.append(name)

    monkeypatch.setattr(mesh_mod, "capturing", lambda device: False)  # no card: the stream's state, stood in
    mesh._timed("bn", collective, "eager")
    assert mesh.stats.calls == {"bn": 1} and set(mesh.stats.seconds) == {"bn"}
    monkeypatch.setattr(mesh_mod, "capturing", lambda device: True)
    with pytest.raises(RuntimeError, match="without a collective tally"):
        mesh._timed("bn", collective, "no tally")
    with mesh_mod.recording() as tally:
        mesh._timed("bn", collective, "captured")
        # autograd runs a captured backward on a thread of its own
        worker = threading.Thread(target=mesh._timed, args=("bn_backward", collective, "backward"))
        worker.start()
        worker.join()
        with pytest.raises(RuntimeError, match="already open"):
            with mesh_mod.recording():
                pass
    assert made == ["eager", "captured", "backward"]  # "no tally" raised before the call
    assert [kind for _, kind in tally] == ["bn", "bn_backward"]
    assert mesh.stats.calls == {"bn": 1}  # recorded, not counted
    graph = graphs.Graph(SimpleNamespace(replay=lambda: None), None, (), tuple(tally))
    for _ in range(3):
        graph.replay()
    assert mesh.stats.calls == {"bn": 4, "bn_backward": 3}
    assert set(mesh.stats.seconds) == {"bn"}  # a replayed call has no host seconds


def test_a_mesh_of_one_rank_makes_no_collective_unless_asked(monkeypatch):
    """``_live``: LOCAL makes none (not even under capture); a subclass that
    makes them at one rank (the probe of ``chip_smoke.py``) makes each."""
    import chip_smoke

    monkeypatch.setattr(dist, "all_reduce", lambda *a, **k: pytest.fail("LOCAL made a collective"))
    x = torch.ones(3)
    assert LOCAL.all_reduce_mean([x], "bn")[0] is x and LOCAL.all_gather(x, "engine", "data") == [x]
    LOCAL.mean_([x], "grads", "batch")
    LOCAL.broadcast_(x, "engine")
    assert LOCAL.stats.calls == {}
    probe = chip_smoke.probe_mesh(torch.device("cpu"))
    calls = []
    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None: calls.append(("all_reduce", group)))
    monkeypatch.setattr(dist, "broadcast", lambda t, src: calls.append(("broadcast", src)))
    monkeypatch.setattr(dist, "all_gather", lambda parts, t, group=None: [p.copy_(t) for p in parts])
    mean = probe.all_reduce_mean([x * 2, x], "bn")
    probe.mean_([x], "grads", "batch")
    probe.broadcast_(x, "engine")
    assert torch.equal(torch.cat(probe.all_gather(x * 3, "engine", "data")), x * 3)
    assert torch.equal(mean[0], x * 2) and probe.capturable and probe.processes == 1
    assert calls == [("all_reduce", None), ("all_reduce", None), ("broadcast", 0)]
    assert probe.stats.calls == {"bn": 1, "grads": 1, "engine": 2}


# ---------------------------------------------------------------------------
# a failed capture raises
# ---------------------------------------------------------------------------


def _failed_capture(fn, device, pool=None, warmup=1):
    raise RuntimeError("capture failed: operation not permitted when stream is capturing")


def test_a_failed_capture_on_a_capturable_mesh_raises(tmp_path, monkeypatch):
    root = str(tmp_path / "syn")
    cli.main(["make-synthetic", "--out-dir", root, "--num-frames", "8", "--frame-size", str(SIZE),
              "--hand-render-version", "3"])
    monkeypatch.setattr(TrainStep, "graphable", property(lambda self: True))
    monkeypatch.setattr(graphs, "capture", _failed_capture)
    cfg = Config(model=ModelConfig(image_size=SIZE),
                 train=TrainConfig(batch_size=2, oversample=1, seed=3, checkpoint_dir=str(tmp_path / "ckpt")))
    trainer = Trainer(cfg, ColibriDataset(root, 0, 1, "train"), None, device="cpu",
                      logger=MetricLogger(stdout=False))
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    assert trainer.graphed
    with pytest.raises(RuntimeError, match="capture failed"):
        trainer.train_epoch(0)
    assert trainer.optimizer.count == 0  # no eager step instead
    assert all(torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())
    engine = _engine(LOCAL)
    engine.capture_mode = "batch"
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    with pytest.raises(RuntimeError, match="capture failed"):
        engine.warmup()
    assert engine.graphs == {}


# ---------------------------------------------------------------------------
# the engine on a two-process data mesh, as two threads
# ---------------------------------------------------------------------------


class _Rendezvous:
    def __init__(self, n: int):
        self.barrier, self.slots = threading.Barrier(n, timeout=60), [None] * n


class ThreadDataMesh(DataMesh):
    """Process ``rank`` of a data mesh of ``world`` threads: the broadcasts and
    the gather between the threads, made through ``_timed`` (counted, or
    tallied under a capture) as the mesh's are."""

    def __init__(self, world: int, rank: int, rendezvous: _Rendezvous, backend: str):
        super().__init__(rank=rank, world=world, device=torch.device("cpu"), process_rank=rank, backend=backend)
        self.rendezvous = rendezvous

    def _exchange(self, tensor):
        rv = self.rendezvous
        rv.barrier.wait()
        rv.slots[self.rank] = tensor.clone()
        rv.barrier.wait()
        parts = list(rv.slots)
        rv.barrier.wait()
        return parts

    def broadcast_(self, tensor, kind, src=0):
        self._timed(kind, lambda: tensor.copy_(self._exchange(tensor)[src]))
        return tensor

    def all_gather(self, tensor, kind, over="space"):
        assert over == "data"
        return self._timed(kind, self._exchange, tensor)


class _Rerun(graphs.Graph):
    """A replay runs the captured function again and writes its results into
    the captured outputs, as a replay overwrites a graph's memory; its
    collectives are made (and counted) again: the threads must meet."""

    def __init__(self, fn, outputs):
        super().__init__(None, outputs, ())
        self.fn = fn

    def replay(self):
        new = self.fn()
        with torch.inference_mode():
            for old, value in zip(*((t,) if torch.is_tensor(t) else t for t in (self.outputs, new))):
                old.copy_(value)


def _standin_capture(fn, device, pool=None, warmup=1):
    """The warm-up runs for real; the captured call's results are kept
    (inference: it has no effect to undo)."""
    for _ in range(warmup):
        fn()
    return _Rerun(fn, fn())


def _engine(mesh):
    cfg = ModelConfig(phi=0, image_size=SIZE)
    model = init_weights(HMDEgoPose(cfg), torch.Generator().manual_seed(0))
    return InferenceEngine(model, cfg, ServingConfig(max_batch_size=2, score_threshold=0.0),
                           frame_shape=(SIZE, SIZE), device="cpu", mesh=mesh)


def _serve_on_threads(mode, frames, cams, graphed: bool):
    """Process 0 dispatches each batch, process 1 follows; each returns
    (its answers or its served count, its engine)."""
    rv = _Rendezvous(2)
    backend = "nccl" if mode == "batch" else "gloo"
    results, errors = [None, None], []

    def run(rank):
        try:
            engine = _engine(ThreadDataMesh(2, rank, rv, backend))
            if graphed:
                engine.capture_mode = mode  # what a card chooses on this mesh
                engine.warmup()
            engine.mesh.stats.reset()
            if rank == 0:
                answers = [engine._to_host(engine._dispatch_device(f, c)) for f, c in zip(frames, cams)]
                engine._stop_followers()
                results[rank] = (answers, engine)
            else:
                results[rank] = (engine.follow(), engine)
        except BaseException as exc:  # noqa: BLE001 - re-raised in the test's thread
            errors.append(exc)
            rv.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors:
        raise errors[0]
    return results


@pytest.mark.parametrize("mode", ["batch", "rows"])
def test_engine_graphs_on_a_data_mesh_answer_as_the_eager_mesh_engine(monkeypatch, mode):
    monkeypatch.setattr(engine_mod, "replicate", mesh_mod.attach)  # the threads share no process group
    monkeypatch.setattr(graphs, "capture", _standin_capture)
    monkeypatch.setattr(graphs, "pool_bytes", lambda pool, device: 0)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, size=(2, SIZE, SIZE, 3), dtype=np.uint8) for _ in range(3)]
    single = _engine(LOCAL)
    cams = [np.tile(single._default_camera()[None], (2, 1)) for _ in frames]
    (got, leader), (served, follower) = _serve_on_threads(mode, frames, cams, graphed=True)
    (want, _), (eager_served, _) = _serve_on_threads(mode, frames, cams, graphed=False)
    assert sorted(leader.graphs) == sorted(follower.graphs) == [2] and leader.eager_batches == 0
    assert served == eager_served == len(frames)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    for g, f, c in zip(got, frames, cams):  # each process predicts its row as one process would
        w = [single._to_host(single._predict(torch.from_numpy(f[i:i + 1]), torch.from_numpy(c[i:i + 1])))
             for i in range(2)]
        for a, *b in zip(g, *w):
            np.testing.assert_array_equal(a, np.concatenate(b))
    # per batch: the command header, the frames' and cameras' broadcasts and the gather; then the stop
    for engine in (leader, follower):
        assert engine.mesh.stats.calls == {"engine": 4 * len(frames) + 1}
