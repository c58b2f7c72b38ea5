"""Data-parallel ranks of the port for the tests: ``torch.distributed`` gloo
ranks on the CPU, each a subprocess of the test.

``run_ranks(world, jobs, tmp_path)`` starts ``world`` processes of this file
with torchrun's environment (``MASTER_ADDR`` 127.0.0.1, a free port,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), one torch thread each; every rank
joins the group through ``parallel/distributed.py::initialize`` (60 s
timeout), runs the jobs in order and saves its results with ``torch.save``.
Every process is joined with a timeout and killed past it; a rank that
exits non-zero or times out fails the test.

Jobs (dicts with a ``kind``):

* ``bn``: cross-replica ``BatchNorm`` on the rank's half of a seeded batch,
  training forward and backward, with ``update_stats`` on and off;
* ``steps``: ``cli.build_trainer`` on a dataset (the trainer's path chosen
  from the overrides), then its own epoch code for a few steps: per step the
  losses and the state digest, at the end the state and the collective
  counts; for the host pipeline and windows also each rank's batch rows;
  with ``graph``, the resident steps through the trainer's step graph under
  the stand-in capture (``standin_capture``) and the graph's collective
  tally;
* ``cli``: ``cli.main(["train", ...])`` in a working directory;
* ``spatial_fit``: ``cli train``'s trainer on a mesh of
  ``job["layout"]``, one epoch of ``fit`` through the stand-in graphs with
  one validation: who validated, logged and wrote checkpoints;
* ``spatial``: on a mesh of ``job["layout"]`` (data, model, space) of its
  own, from a state file the test saved: the raw forward (``forward``), the
  fused predict (``predict``), a train step (``step``) or the engine
  (``engine``: process 0 serves, the others follow) on seeded inputs
  (``spatial_inputs``); whole-height outputs of the rank's data rows.  With
  ``graph``, through the card's graphs under the stand-in capture
  (``standin_graphs``): the step through ``train/step.py::HostGraph``
  (a warm-up step and the capture, then back to the start and one
  replay: the step the eager job takes), the predict through
  ``EvalForward`` (two replays and its eager predict), the engine's
  "batch" graphs captured by every process's ``warmup``.  With ``probe``,
  run in one process of a one-rank group: on ``chip_smoke.probe_space_mesh``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "trained", "syn1000_phi0_576ep_handrel_int8.npz")
RANK_TIMEOUT_S = 60.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, jobs, tmp_path, timeout: float = 240.0, device: str = "cpu"):
    """Run ``jobs`` on ``world`` gloo ranks; returns each rank's list of results.
    ``device`` "cuda": the ranks share card 0 (gloo over the host)."""
    import torch

    job_file = os.path.join(str(tmp_path), f"jobs-{world}.json")
    with open(job_file, "w") as f:
        json.dump({"device": device, "jobs": jobs}, f)
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                   RANK=str(rank), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        log = open(os.path.join(str(tmp_path), f"rank{rank}-{world}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), job_file, str(rank)],
                                       env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(tmp_path)), log))
    deadline = time.monotonic() + timeout
    failed = []
    try:
        for rank, (proc, log) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append((rank, rc))
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        tails = []
        for rank, rc in failed:
            with open(os.path.join(str(tmp_path), f"rank{rank}-{world}.log")) as f:
                tails.append(f"rank {rank} ({rc}):\n{f.read()[-3000:]}")
        raise AssertionError("data-parallel ranks failed:\n" + "\n".join(tails))
    return [torch.load(os.path.join(str(tmp_path), f"out{rank}-{world}.pt"), weights_only=False)
            for rank in range(world)]


# ---------------------------------------------------------------------------
# the jobs (also run in one process, on a mesh of one, as the reference)
# ---------------------------------------------------------------------------


def bn_inputs(batch: int = 4, channels: int = 5, hw: int = 3, seed: int = 0):
    """A seeded NCHW batch, BN weight, bias, running stats and output cotangent."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"x": rng.normal(1.5, 2.0, (batch, channels, hw, hw)).astype(f),
            "weight": rng.uniform(0.5, 1.5, channels).astype(f), "bias": rng.normal(size=channels).astype(f),
            "mean": rng.normal(size=channels).astype(f), "var": rng.uniform(0.5, 2.0, channels).astype(f),
            "cotangent": rng.normal(size=(batch, channels, hw, hw)).astype(f)}


def bn_job(job, mesh, device: str = "cpu"):
    """Training-mode BN of this rank's rows (all rows on a mesh of one):
    output, running statistics and the gradients of input, weight and bias."""
    import torch

    from hmd_ego_pose_tpu_torch.nn.core import BatchNorm
    from hmd_ego_pose_tpu_torch.parallel.mesh import batch_sharding

    inp = bn_inputs(**job.get("shape", {}))
    out = {}
    for update_stats in (True, False):
        bn = BatchNorm(inp["x"].shape[1]).to(device)
        with torch.no_grad():
            for name, key in (("weight", "weight"), ("bias", "bias"), ("running_mean", "mean"),
                              ("running_var", "var")):
                getattr(bn, name).copy_(torch.from_numpy(inp[key]))
        bn.mesh, bn.update_stats = mesh, update_stats
        bn.train()
        x = torch.from_numpy(batch_sharding(mesh)(inp["x"])).to(device).requires_grad_(True)
        y = bn(x)
        y.backward(torch.from_numpy(batch_sharding(mesh)(inp["cotangent"])).to(device))
        out[update_stats] = {"y": y.detach().cpu().numpy(), "x_grad": x.grad.cpu().numpy(),
                             "weight_grad": bn.weight.grad.cpu().numpy(), "bias_grad": bn.bias.grad.cpu().numpy(),
                             "running_mean": bn.running_mean.cpu().numpy(),
                             "running_var": bn.running_var.cpu().numpy()}
    out["collectives"] = dict(mesh.stats.calls)
    return out


def record_first_grads(optimizer, model, out: dict) -> None:
    """Record in ``out["grads"]`` the first step's gradients as the update
    reads them: after the mesh's all-reduce (and the clip), before the
    optimizer's own step."""
    opt_step = optimizer.opt.step

    def recorded_opt_step(*a, **kw):
        if "grads" not in out:
            names = {id(p): k for k, p in model.named_parameters()}
            out["grads"] = {names[id(p)]: p.grad.cpu().numpy() for p in optimizer.params}
        return opt_step(*a, **kw)

    optimizer.opt.step = recorded_opt_step


class _NoLogger:
    def log_scalars(self, step, scalars):
        pass


def build(job, workdir: str, device: str = "cpu"):
    """``cli.build_trainer`` of a ``steps`` job."""
    from hmd_ego_pose_tpu_torch import cli

    argv = ["train", "--dataset-path", job["dataset"], "--ckpt", job.get("ckpt", ARTIFACT),
            "--img-size", str(job["size"]), "--batch-size", str(job["batch"]), "--device", device,
            *job.get("flags", [])]
    args = cli.build_parser().parse_args(argv)
    aug = job.get("augment", False)
    data = {"use_6dof_augmentation": aug, "use_colorspace_augmentation": aug, "num_workers": 1,
            **job.get("data", {})}
    return cli.build_trainer(args, logger=_NoLogger(), data_overrides=data, model_overrides=job.get("model"),
                             checkpoint_dir=os.path.join(workdir, "ckpt"), oversample=job.get("oversample", 10))


@contextlib.contextmanager
def capturing():
    """The mesh's collectives see a CUDA graph capture in progress
    (``parallel/mesh.py::capturing``): they go into the open tally."""
    from hmd_ego_pose_tpu_torch.parallel import mesh as mesh_mod

    real = mesh_mod.capturing
    mesh_mod.capturing = lambda device: True
    try:
        yield
    finally:
        mesh_mod.capturing = real


def _step_tensors(graph):
    """Every tensor a step of ``graph`` (a ``ResidentGraph``) writes: the
    model's state, the optimizer's, the loss rows and the row counter."""
    opt = graph.step.optimizer.opt
    return (list(graph.step.model.state_dict().values()) + [t for s in opt.state.values() for t in s.values()]
            + [graph.metrics, graph.row])


def _tensors(outputs):
    import torch

    return (outputs,) if torch.is_tensor(outputs) else tuple(outputs)


class StandinRerun:
    """The stand-in capture's "graph" of an inference call (a predict, an
    engine batch): a replay runs the call again with its collectives made but
    not counted (the ranks meet as a graph's replays would), writes its
    results into the captured outputs, as a replay overwrites a graph's
    memory, then counts the capture's collectives."""

    def __init__(self, fn, outputs, launches, collectives):
        self.fn, self.outputs, self.launches, self.collectives = fn, outputs, launches, collectives

    def replay(self):
        import torch

        from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
        from hmd_ego_pose_tpu_torch.parallel import mesh as mesh_mod

        with capturing(), mesh_mod.recording():
            new = self.fn()
        with torch.inference_mode():
            for old, value in zip(_tensors(self.outputs), _tensors(new)):
                old.copy_(value)
        for name in self.launches:
            LAUNCHES.add(name)
        for stats, kind in self.collectives:
            stats.replayed(kind)


class StandinGraph:
    """The stand-in capture's "graph" of a step: a replay runs the step again
    with its collectives made but not counted, then counts the capture's
    launches and collectives, as a graph's replay does; the host's side of
    the step (the optimizer's count) is not replayed."""

    def __init__(self, fn, launches, collectives):
        self.fn, self.launches, self.collectives, self.outputs = fn, launches, collectives, None

    def replay(self):
        from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
        from hmd_ego_pose_tpu_torch.parallel import mesh as mesh_mod

        optimizer = self.fn.__self__.step.optimizer
        count = optimizer.count
        with capturing(), mesh_mod.recording():
            self.fn()
        optimizer.count = count
        for name in self.launches:
            LAUNCHES.add(name)
        for stats, kind in self.collectives:
            stats.replayed(kind)


def standin_capture(fn, device, pool=None, warmup=1):
    """``utils/graphs.py::capture`` on the CPU: the warm-up calls run for real;
    the captured call runs with the collectives recorded into the tallies.
    A step's (``fn`` a method of a ``ResidentGraph``) takes no effect (every
    tensor it writes is put back, as a capture runs nothing); an inference
    call's outputs are kept (``StandinRerun``)."""
    import torch

    from hmd_ego_pose_tpu_torch import kernels
    from hmd_ego_pose_tpu_torch.parallel import mesh as mesh_mod
    from hmd_ego_pose_tpu_torch.train.step import ResidentGraph

    for _ in range(warmup):
        fn()
    if not isinstance(getattr(fn, "__self__", None), ResidentGraph):
        with capturing(), kernels.recording() as launches, mesh_mod.recording() as collectives:
            outputs = fn()
        return StandinRerun(fn, outputs, tuple(launches), tuple(collectives))
    tensors = _step_tensors(fn.__self__)
    saved = [t.detach().clone() for t in tensors]
    with capturing(), kernels.recording() as launches, mesh_mod.recording() as collectives:
        fn()
    with torch.no_grad():
        for t, v in zip(tensors, saved):
            t.copy_(v)
    return StandinGraph(fn, tuple(launches), tuple(collectives))


@contextlib.contextmanager
def standin_graphs(on: bool = True):
    """While open (with ``on``), the CPU acts as a card for the graphs:
    ``TrainStep.graphable`` is true, ``utils/graphs.py::capture`` is
    ``standin_capture`` and the engine's graph pool, pool bytes and
    synchronise are no-ops."""
    import torch

    from hmd_ego_pose_tpu_torch.train.step import TrainStep
    from hmd_ego_pose_tpu_torch.utils import graphs

    if not on:
        yield
        return
    saved = (TrainStep.graphable, graphs.capture, graphs.pool_bytes, torch.cuda.graph_pool_handle,
             torch.cuda.synchronize)
    TrainStep.graphable = property(lambda self: True)
    graphs.capture, graphs.pool_bytes = standin_capture, lambda pool, device: 0
    torch.cuda.graph_pool_handle, torch.cuda.synchronize = lambda: (0, 1), lambda device=None: None
    try:
        yield
    finally:
        (TrainStep.graphable, graphs.capture, graphs.pool_bytes, torch.cuda.graph_pool_handle,
         torch.cuda.synchronize) = saved


def steps_job(job, workdir: str, device: str = "cpu"):
    """A few steps of the trainer's own epoch code on its path (resident:
    ``job["steps"]`` steps; windowed and host: one epoch); with ``graph``
    through the step's graph (the stand-in capture: the CPU has no graphs)."""
    graphed = job.get("graph", False)
    with standin_graphs(graphed):
        return _steps(job, build(job, workdir, device), graphed)


def _steps(job, trainer, graphed: bool):
    import torch

    from hmd_ego_pose_tpu_torch.data.device_dataset import gather_raw_batch
    from hmd_ego_pose_tpu_torch.parallel.mesh import batch_sharding, state_digest
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES

    step, mesh = trainer.step_fn, trainer.mesh
    out = {"path": trainer.path, "steps": [], "digests": [], "rows": [], "means": [], "graphed": trainer.graphed}
    prepare, prepare_host, update = step.prepare, step.prepare_host, step.update

    def record(raw):
        out["rows"].append({k: np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                            for k, v in raw._asdict().items()})

    def recorded_prepare(data, idx, draws=None):
        record(gather_raw_batch(data, idx))
        return prepare(data, idx, draws)

    def recorded_prepare_host(batch, draws=None):
        record(batch)
        return prepare_host(batch, draws)

    def recorded_update(bundle):
        metrics = update(bundle)
        out["steps"].append({k: float(metrics[k]) for k in METRIC_NAMES})
        out["digests"].append(state_digest(trainer.model))
        return metrics

    if not graphed:  # a graph's capture runs the step once more, its effects undone
        step.prepare, step.prepare_host, step.update = recorded_prepare, recorded_prepare_host, recorded_update
    record_first_grads(trainer.optimizer, trainer.model, out)
    mesh.stats.reset()
    if trainer.path == "resident":
        idxs = trainer.pipeline.epoch_indices(trainer.config.train.oversample)[:job["steps"]]
        for s in range(idxs.shape[0]):
            if job.get("drop_connect", False):
                means = trainer._resident_steps(idxs[s:s + 1])
                out["means"].append({k: float(v) for k, v in means.items()})
            elif graphed:  # the reference steps through the graph
                trainer.graph.reset()
                trainer.graph(torch.from_numpy(batch_sharding(mesh)(idxs[s]).astype("int64")), trainer.draws(), None)
            else:  # the reference steps: augmentation draws as configured, no drop-connect
                idx = torch.from_numpy(batch_sharding(mesh)(idxs[s])).to(trainer.device)
                step(trainer.data, idx, trainer.draws(), None)
            if graphed:
                out["steps"].append(dict(zip(METRIC_NAMES, trainer.graph.metrics[0].tolist())))
                out["digests"].append(state_digest(trainer.model))
                if s == 0:
                    out["first_state"] = {k: v.detach().cpu().numpy().copy()
                                          for k, v in trainer.model.state_dict().items()}
        if graphed:
            out["tally"] = dict(collections.Counter(kind for _, kind in trainer.graph.graph.collectives))
    elif trainer.path == "windowed":
        trainer._windowed_epoch()
    else:
        trainer._host_epoch()
    out["state"] = {k: v.detach().cpu().numpy().copy() for k, v in trainer.model.state_dict().items()}
    out["collectives"] = dict(mesh.stats.calls)
    out["count"] = trainer.optimizer.count
    return out


def cli_job(job, workdir: str):
    """``cli.main(argv)`` in ``workdir``: the best checkpoint it names, the
    trainer's plateau state and learning rate after ``fit``, the files written."""
    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.train import trainer as trainer_mod

    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    fit, fitted = trainer_mod.Trainer.fit, []

    def recorded_fit(self, *a, **kw):
        best = fit(self, *a, **kw)
        fitted.append(self)
        return best

    trainer_mod.Trainer.fit = recorded_fit
    os.chdir(workdir)
    try:
        best = cli.main(job["argv"])
    finally:
        os.chdir(cwd)
        trainer_mod.Trainer.fit = fit
    t = fitted[0]
    return {"best": best, "lr": t.optimizer.learning_rate, "plateau": dict(vars(t.scheduler)),
            "files": sorted(os.path.relpath(os.path.join(root, f), workdir)
                            for root, _, files in os.walk(workdir) for f in files)}


def spatial_fit_job(job, workdir: str, device: str = "cpu"):
    """One epoch of ``Trainer.fit`` (``cli train``'s config and restore of
    the artifact) on a mesh of ``job["layout"]`` (data, model, space)
    through the stand-in graphs, as a card graphs it on an NCCL space mesh:
    the step's graph and evaluation's predict (``EvalForward``), one
    validation of ``job["eval_images"]`` images.  Whether the rank
    validated, its validation's scalars and collectives, the metric it
    holds, the best checkpoint it names, the files it wrote and the lines
    it logged."""
    import dataclasses
    from types import SimpleNamespace

    import torch

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.config import ParallelConfig
    from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
    from hmd_ego_pose_tpu_torch.parallel.mesh import make_mesh
    from hmd_ego_pose_tpu_torch.train.checkpoint import meta_hand_relative, restore_checkpoint
    from hmd_ego_pose_tpu_torch.train.step import EvalForward
    from hmd_ego_pose_tpu_torch.train.trainer import Trainer

    args = cli.build_parser().parse_args(["train", "--dataset-path", job["dataset"], "--img-size", str(job["size"]),
                                          "--batch-size", str(job["batch"])])
    cfg = cli.train_config(args, oversample=job["oversample"], checkpoint_dir=os.path.join(workdir, "ckpt"))
    params, bn_state, meta = restore_checkpoint(ARTIFACT, device)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, hand_relative=bool(meta_hand_relative(meta))),
        data=dataclasses.replace(cfg.data, use_6dof_augmentation=False, use_colorspace_augmentation=False,
                                 num_workers=1))
    data, model_axis, space = job["layout"]
    mesh = make_mesh(ParallelConfig(data_parallel=data, model_parallel=model_axis, spatial_parallel=space),
                     device=torch.device(device))
    datasets = [ColibriDataset(args.dataset_path, args.fold, args.object_id, split) for split in ("train", "val")]
    logged = []
    logger = SimpleNamespace(log_scalars=lambda step, scalars: logged.append(step))
    with standin_graphs():
        trainer = Trainer(cfg, *datasets, device=device, logger=logger, params=params, bn_state=bn_state, mesh=mesh)
        trainer.predict_fn = EvalForward(trainer.model, cfg, trainer.device)  # what a card builds
        out = {"graphed": trainer.graphed, "validated": None}
        validate = trainer.validate

        def recorded_validate(max_images=None):
            mesh.stats.reset()
            result = validate(max_images)
            out["validated"] = {"scalars": result.scalars(), "collectives": dict(mesh.stats.calls)}
            return result

        trainer.validate = recorded_validate
        best = trainer.fit(epochs=1, max_eval_images=job["eval_images"])
    out.update(coords=[mesh.rank, mesh.model_rank, mesh.space_rank], process_rank=mesh.process_rank,
               captures=trainer.predict_fn.captures, metric=trainer.best_metric,
               best=best and os.path.basename(best), logged=len(logged),
               files=sorted(os.path.relpath(os.path.join(root, f), workdir)
                            for root, _, files in os.walk(workdir) for f in files))
    return out


SPATIAL_SIZE = 128
CAMERA = [570.0, 570.0, 64.0, 64.0, 1000.0, 1.0]


def spatial_inputs(what: str, batch: int, seed: int):
    """The seeded inputs of a ``spatial`` job (those of
    ``tests/test_parallel_spatial.py``): NHWC images and cameras; for a step
    also the ground truth and model points; for the engine uint8 frames."""
    rng = np.random.RandomState(seed)
    f = np.float32
    cams = np.tile(np.asarray([CAMERA], f), (batch, 1))
    if what == "engine":
        return {"frames": rng.randint(0, 255, (batch, SPATIAL_SIZE, SPATIAL_SIZE, 3), np.uint8)}
    if what != "step":
        return {"images": rng.normal(size=(batch, SPATIAL_SIZE, SPATIAL_SIZE, 3)).astype(f) * f(0.3),
                "cams": cams}
    model_points = (rng.normal(size=(1, 64, 3)) * 50).astype(f)
    return {"model_points": model_points,
            "images": rng.normal(size=(batch, SPATIAL_SIZE, SPATIAL_SIZE, 3)).astype(f) * f(0.1),
            "cams": cams,
            "gt_boxes": np.tile(np.asarray([[[30.0, 40.0, 90.0, 100.0]]], f), (batch, 1, 1)),
            "gt_labels": np.zeros((batch, 1), np.int32),
            "gt_transformation": np.tile(np.asarray([[[0.1, 0.2, 0.1, 10.0, -5.0, 500.0, 0.0, 0.0]]], f),
                                         (batch, 1, 1)),
            "gt_coords_3d": np.zeros((batch, 1, 63), f), "gt_valid": np.ones((batch, 1), bool)}


def spatial_model(job, device: str = "cpu"):
    import torch

    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose

    cfg = ModelConfig(phi=0, image_size=SPATIAL_SIZE, compute_dtype="float32", **job.get("model", {}))
    model = HMDEgoPose(cfg)
    model.load_state_dict(torch.load(job["state"], weights_only=False))
    return model.to(device), cfg


def spatial_job(job, device: str = "cpu"):
    """``job["what"]`` on a mesh of ``job["layout"]``; a mesh of one process
    (``LOCAL``) when the job is run in the test's own process, or the space
    probe (``chip_smoke.probe_space_mesh``) with ``probe``; through the
    stand-in graphs with ``graph``."""
    import torch

    from hmd_ego_pose_tpu_torch.config import ParallelConfig
    from hmd_ego_pose_tpu_torch.parallel import distributed
    from hmd_ego_pose_tpu_torch.parallel.mesh import LOCAL, make_mesh

    if job.get("probe", False):
        import chip_smoke

        mesh = chip_smoke.probe_space_mesh(torch.device(device))
    elif distributed.world_size() > 1:
        data, model_axis, space = job["layout"]
        mesh = make_mesh(ParallelConfig(data_parallel=data, model_parallel=model_axis, spatial_parallel=space),
                         device=torch.device(device))
    else:
        mesh = LOCAL
    with standin_graphs(job.get("graph", False)):
        return _spatial(job, mesh, device)


def _spatial(job, mesh, device: str):
    import torch

    from hmd_ego_pose_tpu_torch.config import Config, EvalConfig, ServingConfig, TrainConfig
    from hmd_ego_pose_tpu_torch.models import hmd_ego_pose
    from hmd_ego_pose_tpu_torch.ops.augment_device import Batch
    from hmd_ego_pose_tpu_torch.parallel.mesh import batch_sharding, image_sharding, replicate, state_digest
    from hmd_ego_pose_tpu_torch.serving.engine import InferenceEngine
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES, EvalForward, TrainStep

    graphed = job.get("graph", False)
    model, cfg = spatial_model(job, device)
    what = job["what"]
    inp = spatial_inputs(what, job["batch"], job["seed"])
    out = {"coords": [mesh.rank, mesh.model_rank, mesh.space_rank], "rows": [mesh.rows(job["batch"]).start,
                                                                             mesh.rows(job["batch"]).stop]}
    mesh.stats.reset()
    if what == "predict" and graphed:  # evaluation's predict: whole frames in, the slab cut inside
        replicate(mesh, model)
        rows = batch_sharding(mesh)
        config = Config(model=cfg, eval=EvalConfig(nms_threshold=0.5, max_detections=10))
        forward = EvalForward(model, config, torch.device(device), score_threshold=0.05)
        images, cams = rows(inp["images"]), rows(inp["cams"])
        replays = [forward(images, cams)]  # the capture (its warm-up eager), then a replay
        mesh.stats.reset()
        replays.append(forward(images, cams))  # a replay alone
        out["replay_collectives"] = dict(mesh.stats.calls)
        out["tally"] = dict(collections.Counter(kind for _, kind in forward.graph.collectives))
        out["captures"] = forward.captures
        out["replays"] = [r._asdict() for r in replays]
        out["eager"] = forward.eager(images, cams)._asdict()
    elif what in ("forward", "predict"):
        replicate(mesh, model)
        images = torch.from_numpy(image_sharding(mesh)(inp["images"])).to(device)
        if what == "forward":
            raw = hmd_ego_pose.apply(model, images, cfg)
            out["outputs"] = {k: getattr(raw, k).cpu().numpy() for k in
                              ("classification", "regression", "rotation", "translation_raw", "hand")}
        else:
            cams = torch.from_numpy(batch_sharding(mesh)(inp["cams"])).to(device)
            det = hmd_ego_pose.predict(model, images, cams, cfg, score_threshold=0.05, iou_threshold=0.5,
                                       max_detections=10)
            out["detections"] = {k: v.cpu().numpy() for k, v in det._asdict().items()}
    elif what == "step":
        config = Config(model=cfg, train=TrainConfig(batch_size=job["batch"], learning_rate=1e-3))
        replicate(mesh, model)
        step = TrainStep(model, config, inp["model_points"], torch.device(device), mesh=mesh)
        rows = batch_sharding(mesh)
        fields = [rows(inp[k]) for k in ("images", "cams", "gt_boxes", "gt_labels", "gt_transformation",
                                         "gt_coords_3d", "gt_valid")]

        def generator():
            return torch.Generator().manual_seed(job["drop_connect_seed"]) if "drop_connect_seed" in job else None

        record_first_grads(step.optimizer, model, out)
        if graphed:
            metrics = _graphed_spatial_step(step, Batch(*fields), generator, out)
        else:
            batch = Batch(*(torch.from_numpy(a).to(device) for a in fields))
            metrics = step.update(step.losses(batch, generator()))
        out["metrics"] = {k: float(metrics[k]) for k in METRIC_NAMES}
        out["digest"] = state_digest(model)
        out["state"] = {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}
    elif what == "engine":
        engine = InferenceEngine(model, cfg, ServingConfig(max_batch_size=1, score_threshold=0.0),
                                 frame_shape=(SPATIAL_SIZE, SPATIAL_SIZE), device=device,
                                 mesh=mesh)
        out["batch_sizes"] = engine.batch_sizes
        if graphed:  # what a card chooses on an NCCL space mesh: every process captures
            engine.capture_mode = "batch"
            engine.warmup()
            out["graphs"] = sorted(engine.graphs)
            mesh.stats.reset()
        if engine.leader:
            engine.start()
            try:
                poses = [engine.infer_blocking(frame, timeout=60.0) for frame in inp["frames"]]
            finally:
                engine.stop()
            out["poses"] = [None if p is None else [np.asarray(v, np.float32) for v in p] for p in poses]
            out["eager_batches"] = engine.eager_batches
        else:
            out["served"] = engine.follow()
    else:
        raise ValueError(what)
    out["collectives"] = dict(mesh.stats.calls)
    return out


def _graphed_spatial_step(step, batch, generator, out):
    """The spatial step through ``HostGraph`` (a host pipeline's ``Batch``:
    the graph starts at the forward): its first call (the warm-up step and
    the stand-in capture), then the model and Adam back at the start and
    one replay, with the same drop-connect draws; the replay's losses, its
    gradients (``record_first_grads`` again), the collectives it counts and
    the capture's tally."""
    from types import SimpleNamespace

    import chip_smoke
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES, HostGraph

    model = step.model
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    graph = HostGraph(step, 2)  # the stand-in capture runs its captured call: a second row
    graph(batch, None, generator())
    chip_smoke.restore_state(SimpleNamespace(model=model, optimizer=step.optimizer), start)
    graph.reset()
    out.pop("grads")
    step.mesh.stats.reset()
    graph(batch, None, generator())
    out["replay_collectives"] = dict(step.mesh.stats.calls)
    out["tally"] = dict(collections.Counter(kind for _, kind in graph.graph.collectives))
    out["graph_class"] = type(graph.graph).__name__
    return dict(zip(METRIC_NAMES, graph.metrics[0]))


def run_job(job, mesh, workdir: str, device: str = "cpu"):
    kind = job["kind"]
    if kind == "spatial":
        return spatial_job(job, device)
    if kind == "bn":
        return bn_job(job, mesh, device)
    if kind == "steps":
        return steps_job(job, workdir, device)
    if kind == "cli":
        return cli_job(job, workdir)
    if kind == "spatial_fit":
        return spatial_fit_job(job, workdir)
    raise ValueError(kind)


def main(job_file: str, rank: int) -> None:
    import torch

    from hmd_ego_pose_tpu_torch.parallel import distributed
    from hmd_ego_pose_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    with open(job_file) as f:
        spec = json.load(f)
    device = "cuda:0" if spec["device"] == "cuda" else "cpu"
    assert distributed.initialize(device, shared_device=device != "cpu", timeout=RANK_TIMEOUT_S)
    mesh = make_mesh(device=torch.device(device))
    base = os.path.dirname(job_file)
    results = [run_job(job, mesh, os.path.join(base, f"rank{rank}-job{i}"), device)
               for i, job in enumerate(spec["jobs"])]
    world = mesh.world
    torch.save(results, os.path.join(base, f"out{rank}-{world}.pt"))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
