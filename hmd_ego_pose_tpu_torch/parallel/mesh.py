"""The data-parallel mesh of ``torch.distributed`` ranks, and its collectives.

Counterpart of ``hmd_ego_pose_tpu/parallel/mesh.py``.  Under GSPMD the JAX
package's mesh step *is* the single-device step of the global batch: one
program, the batch sharded over ``data``, every whole-array reduction a
collective.  The port runs one process per rank, each holding B / W rows of
the global batch of B, and makes the same reductions collectives by hand:

* ``BatchNorm`` in training mode: the batch statistics ``[mean, mean_sq]``
  all-reduced (mean over ranks) in one call per application, through
  ``all_reduce_mean``, whose backward all-reduces the gradient too
  (``nn/core.py``);
* the gradients: one all-reduce of a packed buffer (mean over ranks,
  ``mean_``) before the clip, so its norm is the global one
  (``train/state.py``);
* the logged losses: one all-reduce of the six (``train/step.py``);
* the validation metric: computed on rank 0 and broadcast
  (``train/trainer.py``).

Each rank draws the global batch's random values from the shared seed and
takes its rows (drop-connect, device augmentation, host pipeline), so W
ranks compute the single-process step of the same B rows up to float32
summation order, and hold bit-identical parameters.

``DataMesh.stats`` counts the collective calls by kind, with their host
seconds (a call returns when its result is usable on the device).

A single process is a mesh of one (``LOCAL``, the default of every module
that takes a mesh): each collective is then a no-op, and ``world > 1`` is
tested here only.  The collectives run on the default process group.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from hmd_ego_pose_tpu_torch.config import ParallelConfig
from hmd_ego_pose_tpu_torch.parallel import distributed


class CollectiveStats:
    """Collective calls and their host seconds, by kind."""

    def __init__(self):
        self.calls: Dict[str, int] = collections.Counter()
        self.seconds: Dict[str, float] = collections.Counter()

    def reset(self) -> None:
        self.calls.clear()
        self.seconds.clear()

    def add(self, kind: str, seconds: float) -> None:
        self.calls[kind] += 1
        self.seconds[kind] += seconds

    def snapshot(self) -> Dict[str, Any]:
        return {"calls": dict(self.calls), "seconds": dict(self.seconds)}


@dataclasses.dataclass
class DataMesh:
    """``world`` ranks along the data axis; this process is ``rank`` on ``device``."""

    rank: int
    world: int
    device: torch.device
    stats: CollectiveStats = dataclasses.field(default_factory=CollectiveStats)

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch (the JAX package's ``batch_sharding``:
        the batch over ``data``)."""
        return distributed.process_local_batch_slice(global_batch, self.world, self.rank)

    def _timed(self, kind: str, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        self.stats.add(kind, time.perf_counter() - t)
        return out

    def all_reduce_sum_(self, tensor: torch.Tensor, kind: str) -> torch.Tensor:
        """In place: the sum over ranks."""
        if self.world > 1:
            self._timed(kind, dist.all_reduce, tensor)
        return tensor

    def all_reduce_mean(self, tensors: Sequence[torch.Tensor], kind: str) -> List[torch.Tensor]:
        """The mean over ranks of each tensor, as new tensors, in one call of
        the tensors packed together; differentiable: the backward all-reduces
        the incoming gradient (kind ``<kind>_backward``)."""
        if self.world == 1:
            return list(tensors)
        flat = _AllReduceMean.apply(torch.cat([t.reshape(-1) for t in tensors]), self, kind)
        return [piece.view_as(t) for t, piece in zip(tensors, flat.split([t.numel() for t in tensors]))]

    def mean_(self, tensors: Sequence[torch.Tensor], kind: str) -> None:
        """In place: each tensor becomes its mean over ranks, in one all-reduce
        of the tensors packed into one buffer."""
        if self.world == 1 or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce_sum_(flat, kind)
        flat /= self.world
        for t, piece in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(piece.view_as(t))

    def broadcast_(self, tensor: torch.Tensor, kind: str, src: int = 0) -> torch.Tensor:
        if self.world > 1:
            self._timed(kind, dist.broadcast, tensor, src)
        return tensor

    def barrier(self) -> None:
        if self.world > 1:
            self._timed("barrier", dist.barrier)


class _AllReduceMean(torch.autograd.Function):
    """y = (1 / W) sum_r x_r on every rank; the gradient of x_r is (1 / W)
    sum_r' dL_r' / dy, the all-reduced mean of the incoming gradients.  Every
    rank runs the same graph, so the backward collectives line up."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataMesh, kind: str) -> torch.Tensor:
        ctx.mesh, ctx.kind = mesh, kind
        y = x.detach().clone()
        mesh.all_reduce_sum_(y, kind)
        return y / mesh.world

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = grad.contiguous().clone()
        ctx.mesh.all_reduce_sum_(g, f"{ctx.kind}_backward")
        return g / ctx.mesh.world, None, None


def make_mesh(config: ParallelConfig = ParallelConfig(), world: Optional[int] = None,
              rank: Optional[int] = None, device: Optional[torch.device] = None) -> DataMesh:
    """The data-only mesh over ``world`` ranks (this process's group by
    default); raises as the JAX package's ``make_mesh`` does when the layout
    does not cover the ranks (``ParallelConfig`` refuses the model and space
    axes)."""
    n = distributed.world_size() if world is None else int(world)
    model, space = max(1, config.model_parallel), max(1, config.spatial_parallel)
    data = config.data_parallel if config.data_parallel > 0 else n // (model * space)
    if data * model * space != n:
        raise ValueError(f"mesh {data}x{model}x{space} != {n} ranks")
    return DataMesh(rank=distributed.rank() if rank is None else int(rank), world=n,
                    device=torch.device("cpu") if device is None else torch.device(device))


# a single process: every collective a no-op
LOCAL = DataMesh(rank=0, world=1, device=torch.device("cpu"))


def shard_batch(mesh: DataMesh, batch):
    """This rank's rows of an array (a tensor or numpy array) whose leading
    axis is the global batch."""
    return batch[mesh.rows(batch.shape[0])]


def state_digest(module: torch.nn.Module) -> str:
    """sha256 of every parameter's and buffer's bytes, in ``state_dict`` order."""
    h = hashlib.sha256()
    for key, value in module.state_dict().items():
        h.update(key.encode() + b"\0" + value.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def replicate(mesh: DataMesh, module: torch.nn.Module) -> None:
    """Replicate ``module`` over the mesh (``replicated_sharding`` of the JAX
    package): rank 0's parameters and buffers broadcast to every rank, one
    broadcast per dtype; then every rank's ``state_digest`` must agree (one
    all-reduce).  Attaches the mesh to every module with a ``mesh`` attribute
    (``BatchNorm``, ``EfficientNet``)."""
    for m in module.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh
    if mesh.world == 1:
        return
    tensors = list(module.state_dict().values())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in group]).to(mesh.device)
        mesh.broadcast_(flat, "replicate")
        with torch.no_grad():
            for t, piece in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(piece.view_as(t))
    value = int(state_digest(module)[:15], 16)  # 60 bits: exact in int64
    both = torch.tensor([value, -value], dtype=torch.int64, device=mesh.device)
    mesh._timed("replicate", dist.all_reduce, both, op=dist.ReduceOp.MAX)
    if int(both[0]) != value or int(-both[1]) != value:
        raise RuntimeError(f"rank {mesh.rank}: the replicated state differs across ranks")
