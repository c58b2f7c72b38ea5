"""The mesh of ``torch.distributed`` ranks over (data, model, space), and its collectives.

Counterpart of ``hmd_ego_pose_tpu/parallel/mesh.py``.  Rank r sits where the
JAX package's ``np.asarray(devices).reshape(data, model, space)`` puts device
r: r = (d * model + m) * space + s.  Under GSPMD the JAX package's mesh
program *is* the single-device program: one program, the batch sharded over
``data``, the image height over ``space``, every whole-array reduction a
collective.  The port runs one process per rank and makes the same
reductions collectives by hand:

* ``data`` (``rank`` and ``world`` of ``DataMesh`` are this axis's index and
  size): each data row holds B / D rows of the global batch; the logged
  losses are all-reduced over it (``train/step.py``), the validation metric
  is computed on process 0 and broadcast (``train/trainer.py``);
* ``space`` (``space_rank``, ``space``): the image height of a data row split
  into slabs (``parallel/spatial.py`` holds the halo exchanges, gathers and
  sums that GSPMD inserts; ``nn/core.py`` and ``models/`` call them);
* ``model``: ranks along it hold replicas and compute the same thing, as the
  JAX package's ``model`` axis replicates the work;
* ``BatchNorm`` in training mode: the statistics ``[mean, mean_sq]``
  all-reduced (mean) in one call per application over the data axis, or over
  (data x space) for a level split into slabs (``nn/core.py``), through
  ``all_reduce_mean``, whose backward all-reduces the gradient too;
* the gradients: one all-reduce of a packed buffer over (data x space), the
  mean over its D * S ranks, before the clip, so its norm is the global one
  (``train/state.py``).

Each rank draws the global batch's random values from the shared seed and
takes its data rows (drop-connect, device augmentation, host pipeline), so
every space and model rank of a data row draws the same, and the ranks
compute the single-process step of the same B rows up to float32 summation
order, and hold bit-identical parameters.

The ``data`` and ``space`` axes and (data x space) have their process
subgroups (``MeshGroups``), made by every rank in the same order by
``make_mesh``; ``model`` has none, as no collective runs along it.  A
data-only mesh makes none: its collectives run on the default group, as they
did before the other axes existed.

``DataMesh.stats`` counts the collective calls by kind, with their host
seconds (a call returns when its result is usable on the device).  A
collective made while this thread's stream captures a CUDA graph runs
nothing: it is recorded into the graph, and every replay runs it.  So it is
not counted; it goes into the tally of the capture in progress
(``recording``, which ``utils/graphs.py::capture`` opens, as
``kernels.recording`` for the kernels; BN's backward collective is made on
autograd's thread), and each replay adds that tally to the calls, with no
host seconds (a replayed call has none of its own).

``DataMesh.capturable`` says whether a CUDA graph can hold the mesh's
collectives: NCCL's go on the CUDA stream and are captured, those of every
axis (the space axis's halo exchanges, gathers and sums too); gloo's go
through the host and are not.

A single process is a mesh of one (``LOCAL``, the default of every module
that takes a mesh): each collective is then a no-op, and a mesh of more than
one rank is tested here only.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import itertools
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from hmd_ego_pose_tpu_torch.config import ParallelConfig
from hmd_ego_pose_tpu_torch.parallel import distributed


class CollectiveStats:
    """Collective calls and their host seconds, by kind: an eager call adds
    both (``add``), a call replayed in a CUDA graph only the call
    (``replayed``)."""

    def __init__(self):
        self.calls: Dict[str, int] = collections.Counter()
        self.seconds: Dict[str, float] = collections.Counter()

    def reset(self) -> None:
        self.calls.clear()
        self.seconds.clear()

    def add(self, kind: str, seconds: float) -> None:
        self.calls[kind] += 1
        self.seconds[kind] += seconds

    def replayed(self, kind: str) -> None:
        self.calls[kind] += 1

    def snapshot(self) -> Dict[str, Any]:
        return {"calls": dict(self.calls), "seconds": dict(self.seconds)}


# the tally of the capture in progress: the process's, not a thread's, since
# autograd runs a captured backward (BN's all-reduce) on a thread of its own
_capture_lock = threading.Lock()
_capture_tally: Optional[List[Tuple[CollectiveStats, str]]] = None


@contextlib.contextmanager
def recording() -> Iterator[List[Tuple[CollectiveStats, str]]]:
    """Open the tally of the collectives a CUDA graph capture records (one at
    a time in a process); yields the list, which holds one (the mesh's stats,
    kind) per recorded call."""
    global _capture_tally
    with _capture_lock:
        if _capture_tally is not None:
            raise RuntimeError("a collective tally is already open")
        _capture_tally = tally = []
    try:
        yield tally
    finally:
        with _capture_lock:
            _capture_tally = None


def capturing(device: torch.device) -> bool:
    """Whether this thread's current stream on ``device`` captures a CUDA graph."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """This rank's process subgroups: along ``data``, along ``space``, and
    over (data x space) (``batch``: the BN statistics of a split level and the
    gradients).  None is the default group (every rank); a group of one rank
    is never used.  The ``model`` axis has none: no collective runs along it."""

    data: Any = None
    space: Any = None
    batch: Any = None


@dataclasses.dataclass
class DataMesh:
    """This process on the mesh: ``rank`` / ``world`` are its index along and
    the size of the data axis, ``space_rank`` / ``space`` and ``model_rank`` /
    ``model`` those of the other two axes, ``process_rank`` its rank in the
    process group, ``backend`` the group's ("" without one); its tensors
    live on ``device``."""

    rank: int
    world: int
    device: torch.device
    stats: CollectiveStats = dataclasses.field(default_factory=CollectiveStats)
    space: int = 1
    space_rank: int = 0
    model: int = 1
    model_rank: int = 0
    process_rank: int = 0
    groups: MeshGroups = dataclasses.field(default_factory=MeshGroups)
    backend: str = ""

    def __deepcopy__(self, memo):  # a handle on the process group: copies of a module share it
        return self

    @property
    def processes(self) -> int:
        return self.world * self.model * self.space

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this mesh's collectives: a single
        process (it makes none), or NCCL ranks, each on a card of its own
        (NCCL refuses two ranks on one card), along any axes: the data
        axis's, and the space axis's halo exchanges, gathers and sums (the
        model axis makes none).  Not gloo, whose collectives go through the
        host."""
        if self.processes == 1:
            return True
        return self.backend == "nccl" and self.device.type == "cuda"

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch (the JAX package's ``batch_sharding``:
        the batch over ``data``)."""
        return distributed.process_local_batch_slice(global_batch, self.world, self.rank)

    def sharded(self, height: int) -> bool:
        """Whether a level of ``height`` rows is split into slabs over ``space``:
        when the axis is not trivial and divides it.  A smaller or uneven level
        is computed whole on every rank of the space group (GSPMD pads it)."""
        return self.space > 1 and height % self.space == 0

    def height_rows(self, height: int) -> slice:
        """This rank's rows of a level of ``height`` rows (all of them when the
        level is not split)."""
        if not self.sharded(height):
            return slice(0, height)
        per = height // self.space
        return slice(self.space_rank * per, (self.space_rank + 1) * per)

    def _axis(self, over: str) -> Tuple[Any, int]:
        if over == "data":
            return self.groups.data, self.world
        if over == "batch":
            return self.groups.batch, self.world * self.space
        if over == "space":
            return self.groups.space, self.space
        raise ValueError(over)

    def _live(self, size: int) -> bool:
        """Whether a collective over ``size`` ranks is made: over one rank it is
        a no-op and is not made (a subclass may make it anyway: the probe of
        ``chip_smoke.py`` captures a step's collectives on one NCCL rank)."""
        return size > 1

    def reduces(self, over: str) -> bool:
        """Whether a collective along axis ``over`` is made (``_live``)."""
        return self._live(self._axis(over)[1])

    def _timed(self, kind: str, fn, *args, **kwargs):
        """Make the collective ``fn(*args, **kwargs)``: counted with its host
        seconds, or, while this thread's stream captures a CUDA graph (the
        capturing thread's, or autograd's in a captured backward), recorded
        into the capture's tally (``recording``); a capture without an open
        tally raises, so a replay never makes a call it does not count."""
        if capturing(self.device):
            tally = _capture_tally
            if tally is None:
                raise RuntimeError(f"a {kind} collective inside a CUDA graph capture without a collective tally "
                                   "(capture through utils/graphs.py::capture)")
            out = fn(*args, **kwargs)
            with _capture_lock:
                tally.append((self.stats, kind))
            return out
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        self.stats.add(kind, time.perf_counter() - t)
        return out

    def all_reduce_sum_(self, tensor: torch.Tensor, kind: str, over: str = "data") -> torch.Tensor:
        """In place: the sum over the ranks of axis ``over`` ("data", "space" or
        "batch", the last data x space)."""
        group, size = self._axis(over)
        if self._live(size):
            self._timed(kind, dist.all_reduce, tensor, group=group)
        return tensor

    def all_gather(self, tensor: torch.Tensor, kind: str, over: str = "space") -> List[torch.Tensor]:
        """Every rank's ``tensor`` along axis ``over``, in axis order."""
        group, size = self._axis(over)
        if not self._live(size):
            return [tensor]
        return self._all_gather(tensor.contiguous(), kind, group, size)

    def _all_gather(self, tensor: torch.Tensor, kind: str, group: Any, size: int) -> List[torch.Tensor]:
        """The all-gather over ``group`` of ``size`` ranks, into a list (the
        space probe of ``chip_smoke.py`` gathers over one rank and stands in
        for the absent one)."""
        parts = [torch.empty_like(tensor) for _ in range(size)]
        self._timed(kind, dist.all_gather, parts, tensor, group=group)
        return parts

    def all_reduce_mean(self, tensors: Sequence[torch.Tensor], kind: str, over: str = "data") -> List[torch.Tensor]:
        """The mean over the ranks of axis ``over`` of each tensor, as new
        tensors, in one call of the tensors packed together; differentiable:
        the backward all-reduces the incoming gradient (kind ``<kind>_backward``)."""
        if not self.reduces(over):
            return list(tensors)
        flat = _AllReduceMean.apply(torch.cat([t.reshape(-1) for t in tensors]), self, kind, over)
        return [piece.view_as(t) for t, piece in zip(tensors, flat.split([t.numel() for t in tensors]))]

    def mean_(self, tensors: Sequence[torch.Tensor], kind: str, over: str = "data") -> None:
        """In place: each tensor becomes its mean over the ranks of axis
        ``over``, in one all-reduce of the tensors packed into one buffer."""
        size = self._axis(over)[1]
        if not self._live(size) or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce_sum_(flat, kind, over)
        flat /= size
        for t, piece in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(piece.view_as(t))

    def broadcast_(self, tensor: torch.Tensor, kind: str, src: int = 0) -> torch.Tensor:
        """In place: process ``src``'s tensor on every process of the mesh."""
        if self._live(self.processes):
            self._timed(kind, dist.broadcast, tensor, src)
        return tensor

    def barrier(self) -> None:
        if self._live(self.processes):
            self._timed("barrier", dist.barrier)


class _AllReduceMean(torch.autograd.Function):
    """y = (1 / W) sum_r x_r on every rank of the axis; the gradient of x_r is
    (1 / W) sum_r' dL_r' / dy, the all-reduced mean of the incoming gradients.
    Every rank runs the same graph, so the backward collectives line up."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataMesh, kind: str, over: str) -> torch.Tensor:
        ctx.mesh, ctx.kind, ctx.over = mesh, kind, over
        y = x.detach().clone()
        mesh.all_reduce_sum_(y, kind, over)
        return y / mesh._axis(over)[1]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = grad.contiguous().clone()
        ctx.mesh.all_reduce_sum_(g, f"{ctx.kind}_backward", ctx.over)
        return g / ctx.mesh._axis(ctx.over)[1], None, None, None


def _new_groups(shape: Tuple[int, int, int], coords: Tuple[int, int, int]) -> MeshGroups:
    """Every subgroup of the mesh, made by every rank in the same order
    (``dist.new_group`` is collective); keeps this rank's.  Axes of one rank
    get none.

    A communicator first used inside a CUDA graph capture cannot be made
    there.  An NCCL group that ``parallel/distributed.py::initialize`` made
    is bound to the rank's card (``device_id``), and ``dist.new_group``
    under a bound group connects each subgroup's communicator on that card
    at once (split from the group's), so the ``space`` and ``batch``
    communicators exist when ``make_mesh`` returns, before any capture; the
    capture's warm-up (``utils/graphs.py::capture``) then makes every
    collective of the captured function once more, eagerly."""
    data, model, space = shape
    ranks = np.arange(data * model * space).reshape(shape)
    mine = {}
    # (name, the axes a group spans); the batch group is data x space
    for name, axes in (("data", (0,)), ("space", (2,)), ("batch", (0, 2))):
        if int(np.prod([shape[a] for a in axes])) == 1:
            continue
        rest = [a for a in range(3) if a not in axes]
        for fixed in itertools.product(*(range(shape[a]) for a in rest)):
            index = [slice(None)] * 3
            for a, v in zip(rest, fixed):
                index[a] = v
            members = sorted(int(r) for r in ranks[tuple(index)].reshape(-1))
            group = dist.new_group(members)
            if all(coords[a] == v for a, v in zip(rest, fixed)):
                mine[name] = group
    return MeshGroups(**mine)


def make_mesh(config: ParallelConfig = ParallelConfig(), world: Optional[int] = None,
              rank: Optional[int] = None, device: Optional[torch.device] = None) -> DataMesh:
    """The (data, model, space) mesh over ``world`` ranks (this process's group
    by default), this process at ``rank``; raises as the JAX package's
    ``make_mesh`` does when the layout does not cover the ranks.  With the
    process group up and a model or space axis above 1, every rank must call
    it: it makes the subgroups."""
    n = distributed.world_size() if world is None else int(world)
    model, space = max(1, config.model_parallel), max(1, config.spatial_parallel)
    data = config.data_parallel if config.data_parallel > 0 else n // (model * space)
    if data * model * space != n:
        raise ValueError(f"mesh {data}x{model}x{space} != {n} ranks")
    shape = (data, model, space)
    r = distributed.rank() if rank is None else int(rank)
    d, m, s = (int(c) for c in np.unravel_index(r, shape))
    groups, backend = MeshGroups(), ""
    if dist.is_available() and dist.is_initialized():
        backend = str(dist.get_backend())
        if shape[1] > 1 or shape[2] > 1:
            groups = _new_groups(shape, (d, m, s))
    return DataMesh(rank=d, world=shape[0], device=torch.device("cpu") if device is None else torch.device(device),
                    space=shape[2], space_rank=s, model=shape[1], model_rank=m, process_rank=r, groups=groups,
                    backend=backend)


# a single process: every collective a no-op
LOCAL = DataMesh(rank=0, world=1, device=torch.device("cpu"))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which part of an array this rank holds: ``spec`` names the mesh axis of
    each leading dimension (None: whole), as a JAX ``PartitionSpec`` does;
    calling it on the global array returns this rank's part."""

    mesh: DataMesh
    spec: Tuple[Optional[str], ...]

    def __call__(self, array):
        index = []
        for axis, size in zip(self.spec, array.shape):
            if axis == "data":
                index.append(self.mesh.rows(size))
            elif axis == "space":
                index.append(self.mesh.height_rows(size))
            else:
                index.append(slice(None))
        return array[tuple(index)]


def batch_sharding(mesh: DataMesh) -> Sharding:
    """Dim 0 (the batch) over ``data``, the rest whole: this rank's rows of a
    tensor or numpy array whose leading axis is the global batch."""
    return Sharding(mesh, ("data",))


def replicated_sharding(mesh: DataMesh) -> Sharding:
    return Sharding(mesh, ())


def image_sharding(mesh: DataMesh) -> Sharding:
    """NHWC images: the batch over ``data``, the height over ``space``; a
    trivial space axis leaves the height whole, and so does a height the axis
    does not divide (``DataMesh.sharded``)."""
    return Sharding(mesh, ("data", "space" if mesh.space > 1 else None))


def state_digest(module: torch.nn.Module) -> str:
    """sha256 of every parameter's and buffer's bytes, in ``state_dict`` order."""
    h = hashlib.sha256()
    for key, value in module.state_dict().items():
        h.update(key.encode() + b"\0" + value.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def attach(mesh: DataMesh, module: torch.nn.Module) -> None:
    """Give ``mesh`` to every module with a ``mesh`` attribute (``BatchNorm``,
    ``Conv2dSame``, ``EfficientNet``, the BiFPN cells and heads)."""
    for m in module.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh


def replicate(mesh: DataMesh, module: torch.nn.Module) -> None:
    """Replicate ``module`` over the mesh (``replicated_sharding`` of the JAX
    package): process 0's parameters and buffers broadcast to every process,
    one broadcast per dtype; then every process's ``state_digest`` must agree
    (one all-reduce).  Attaches the mesh (``attach``)."""
    attach(mesh, module)
    if mesh.processes == 1:
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
        raise RuntimeError(f"process {mesh.process_rank}: the replicated state differs across ranks")
