"""The port's mesh and process bootstrap against the JAX package's, in one process.

* ``ParallelConfig``: the JAX dataclass's fields and defaults;
* ``make_mesh``: a layout (data, model and space axes) builds or raises as
  the JAX ``make_mesh`` does over that many devices (the conftest's 8 CPU
  devices), each rank where JAX puts its device; the shardings' specs
  those of the JAX package;
* ``process_local_batch_slice``: the JAX package's rows at world sizes 1, 2, 4;
* ``initialize``: a no-op without torchrun's environment; the backend is
  the caller's (gloo on the CPU or for a shared card, NCCL otherwise);
* a rank's rows of the global batch's random draws (augmentation,
  drop-connect, host pipeline) are the single process's rows;
* every kernel launches with its tensors' card made the current device.
"""

import ast
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from hmd_ego_pose_tpu.config import ParallelConfig as JaxParallelConfig
from hmd_ego_pose_tpu.parallel import distributed as jax_distributed
from hmd_ego_pose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hmd_ego_pose_tpu_torch import kernels
from hmd_ego_pose_tpu_torch.config import ParallelConfig
from hmd_ego_pose_tpu_torch.models.efficientnet import EfficientNet, MBConv
from hmd_ego_pose_tpu_torch.ops import augment_device as aug
from hmd_ego_pose_tpu_torch.parallel import distributed
from hmd_ego_pose_tpu_torch.parallel.mesh import (
    LOCAL, DataMesh, batch_sharding, image_sharding, make_mesh, replicated_sharding)

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "hmd_ego_pose_tpu_torch")


def test_parallel_config_is_the_jax_dataclass():
    port = {f.name: f.default for f in dataclasses.fields(ParallelConfig)}
    assert port == {f.name: f.default for f in dataclasses.fields(JaxParallelConfig)}


@pytest.mark.parametrize("n, data, model, space", [
    (1, -1, 1, 1), (2, -1, 1, 1), (4, -1, 1, 1), (8, -1, 1, 1), (2, 2, 1, 1), (4, 4, 1, 1), (4, 2, 1, 1),
    (2, 4, 1, 1), (8, 3, 1, 1),
    (8, 2, 1, 4), (8, -1, 1, 4), (4, 1, 1, 4), (4, -1, 2, 2), (8, 2, 2, 2), (8, -1, 4, 1), (2, 1, 2, 1),
    (8, 2, 1, 3),  # does not cover the ranks
    (6, -1, 4, 1),  # the derived data axis does not either
])
def test_make_mesh_builds_or_raises_as_jax(n, data, model, space):
    layout = dict(data_parallel=data, model_parallel=model, spatial_parallel=space)
    try:
        want = jax_make_mesh(JaxParallelConfig(**layout), devices=jax.devices()[:n])
    except ValueError:
        with pytest.raises(ValueError, match="mesh"):
            make_mesh(ParallelConfig(**layout), world=n, rank=0)
        return
    for r in range(n):
        mesh = make_mesh(ParallelConfig(**layout), world=n, rank=r)
        where = tuple(int(i[0]) for i in np.nonzero(want.devices == jax.devices()[r]))
        assert (mesh.rank, mesh.model_rank, mesh.space_rank) == where
        assert (mesh.world, mesh.model, mesh.space) == (want.shape["data"], want.shape["model"], want.shape["space"])
        assert mesh.process_rank == r and mesh.processes == n


def test_shardings_are_the_jax_packages():
    """The specs of ``tests/test_parallel_spatial.py::test_make_mesh_spatial_axis``;
    each rank's part of a global array."""
    mesh = make_mesh(ParallelConfig(data_parallel=2, spatial_parallel=4), world=8, rank=6)
    assert (mesh.rank, mesh.space_rank) == (1, 2)
    assert image_sharding(mesh).spec == ("data", "space")
    assert image_sharding(make_mesh(ParallelConfig(), world=8, rank=0)).spec == ("data", None)
    assert batch_sharding(mesh).spec == ("data",) and replicated_sharding(mesh).spec == ()
    images = np.arange(4 * 16 * 3 * 1).reshape(4, 16, 3, 1)
    assert (image_sharding(mesh)(images) == images[2:4, 8:12]).all()
    assert (batch_sharding(mesh)(images) == images[2:4]).all()
    assert (replicated_sharding(mesh)(images) == images).all()
    # a height the space axis does not divide stays whole (the level is computed whole)
    assert (image_sharding(mesh)(images[:, :6]) == images[2:4, :6]).all()
    assert mesh.sharded(16) and not mesh.sharded(6) and not LOCAL.sharded(16)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_process_local_batch_slice_matches_jax(world, monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: world)
    for index in range(world):
        monkeypatch.setattr(jax, "process_index", lambda index=index: index)
        for batch in (world, 16, 4 * world + 2):
            assert distributed.process_local_batch_slice(batch, world, index) == \
                jax_distributed.process_local_batch_slice(batch)


def test_initialize_is_a_noop_without_the_environment(monkeypatch):
    for key in distributed.ENV:
        monkeypatch.delenv(key, raising=False)
    assert distributed.initialize("cpu") is False
    assert distributed.world_size() == 1 and distributed.rank() == 0
    assert distributed.process_local_batch_slice(16) == slice(0, 16)
    assert distributed.local_device("cpu") == torch.device("cpu")


def test_backend_is_the_callers_choice(monkeypatch):
    assert distributed.backend_for(torch.device("cpu")) == "gloo"
    assert distributed.backend_for(torch.device("cuda", 1)) == "nccl"
    assert distributed.backend_for(torch.device("cuda", 0), shared_device=True) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.local_device() == torch.device("cuda", 3)
    assert distributed.local_device(shared_device=True) == torch.device("cuda", 0)
    assert distributed.local_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # no rank falls back to the CPU
        distributed.local_device()


def test_shard_batch_takes_the_ranks_rows():
    """``batch_sharding``, the one way to take a rank's rows of the global batch."""
    for full in (torch.arange(24).reshape(8, 3), np.arange(8 * 5).reshape(8, 5)):
        for rank in range(4):
            got = batch_sharding(DataMesh(rank=rank, world=4, device=torch.device("cpu")))(full)
            assert type(got) is type(full) and (got == full[2 * rank:2 * rank + 2]).all()
        assert (batch_sharding(LOCAL)(full) == full).all()


def draws_with_noise(batch: int):
    """Draws of a batch where some rows of both slots run the noise op."""
    for seed in range(100):
        d = aug.draw_augment(torch.Generator().manual_seed(seed), batch, 12, 10)
        if all(sum(op == aug.GAUSSIAN_NOISE for op in aug.slot_ops(d, s)) >= 2 for s in range(aug.MAX_SLOTS)):
            return d
    raise AssertionError("no seed gives noise in both slots")


@pytest.mark.parametrize("world", [2, 4])
def test_a_ranks_draws_augment_its_rows_as_the_single_process(world):
    batch = 2 * aug.NUM_OPS
    draws = draws_with_noise(batch)
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (batch, 12, 10, 3), dtype=np.uint8))
    full = aug.color_augment_batch(images, draws)
    for rank in range(world):
        rows = DataMesh(rank=rank, world=world, device=torch.device("cpu")).rows(batch)
        mine = aug.take_rows(draws, rows)
        assert torch.equal(aug.color_augment_batch(images[rows], mine), full[rows])
        assert torch.equal(mine.angles, draws.angles[rows]) and torch.equal(mine.apply, draws.apply[rows])


def test_drop_connect_masks_are_the_global_batchs_columns(monkeypatch):
    """A rank draws the masks of the global batch and keeps its columns."""
    masks = []
    forward = MBConv.forward

    def recording(self, x, keep_mask=None, keep_prob=1.0, full_h=None):
        masks.append(None if keep_mask is None else keep_mask.clone())
        return forward(self, x, keep_mask, keep_prob, full_h)

    monkeypatch.setattr(MBConv, "forward", recording)
    net = EfficientNet(0).train()
    x = torch.zeros((4, 3, 32, 32))
    with torch.no_grad():
        net(x, torch.Generator().manual_seed(5))
        single, masks[:] = list(masks), []
        net.mesh = DataMesh(rank=1, world=2, device=torch.device("cpu"))  # BNs stay local
        net(x[2:], torch.Generator().manual_seed(5))
    assert len(masks) == len(single) and any(m is not None for m in single)
    for got, want in zip(masks, single):
        assert (got is None and want is None) or torch.equal(got, want[2:])


def test_trainer_refuses_a_batch_that_does_not_divide():
    from hmd_ego_pose_tpu_torch.config import Config
    from hmd_ego_pose_tpu_torch.train.trainer import Trainer

    with pytest.raises(ValueError, match="not divisible by data-axis size 3"):
        Trainer(Config(), None, None, device="cpu", mesh=DataMesh(rank=0, world=3, device=torch.device("cpu")))


class _Recorder:
    def __init__(self):
        self.entered, self.calls = [], []

    def device(self, dev):
        recorder = self

        class Guard:
            def __enter__(self):
                recorder.entered.append(dev)

            def __exit__(self, *exc):
                recorder.entered.append(None)

        return Guard()


def test_launch_makes_the_tensors_card_current(monkeypatch):
    """A ``<<<...>>>`` launch goes to the current device: ``kernels.launch``
    calls the launcher inside ``torch.cuda.device(tensor's device)``, with that
    device's stream (the launcher and the CUDA calls are mocked here)."""
    from hmd_ego_pose_tpu_torch.kernels import build

    rec = _Recorder()
    dev = torch.device("cuda", 1)

    class Lib:
        @staticmethod
        def hegp_target_assign(*args):
            rec.calls.append((list(rec.entered), args))
            return 0

    monkeypatch.setattr(build, "library", lambda name: Lib)
    monkeypatch.setattr(torch.cuda, "device", rec.device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: type("S", (), {"cuda_stream": 1000 + d.index}))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    kernels.LAUNCHES.reset()
    kernels.launch("target_assign", "hegp_target_assign", dev, 7, 8)
    assert rec.calls == [([dev], (7, 8, 1001))] and rec.entered == [dev, None]
    assert kernels.LAUNCHES.snapshot() == {"target_assign": 1}
    Lib.hegp_target_assign = staticmethod(lambda *args: 700)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        kernels.launch("target_assign", "hegp_target_assign", dev)
    assert kernels.LAUNCHES.snapshot() == {"target_assign": 1}


def test_every_kernel_wrapper_launches_through_the_guard():
    """No module of the port takes a stream or calls a kernel library but ``kernels.launch``."""
    offenders = []
    for root, _, files in os.walk(PORT):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Attribute) and node.attr in ("current_stream", "cuda_stream", "library"):
                    offenders.append((os.path.relpath(path, PORT), node.attr, node.lineno))
    assert all(path in ("kernels/__init__.py", os.path.join("kernels", "__init__.py")) for path, _, _ in offenders), \
        offenders
    used = {}
    for name in ("target_assign", "distances", "quantization"):
        with open(os.path.join(PORT, "ops", f"{name}.py")) as f:
            used[name] = "launch(" in f.read()
    assert all(used.values()), used
