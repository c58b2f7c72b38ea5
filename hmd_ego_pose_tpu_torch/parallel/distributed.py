"""Multi-process bootstrap on ``torch.distributed``.

Counterpart of ``hmd_ego_pose_tpu/parallel/distributed.py``.  The JAX
package reads ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``; the port reads what ``torchrun`` sets for every rank:
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``.

    torchrun --nproc-per-node N -m hmd_ego_pose_tpu_torch.cli train ...

The backend is the caller's choice, never a retry: ``nccl`` when every rank
has a card of its own (rank r on ``cuda:LOCAL_RANK``), ``gloo`` on the CPU
(``--device cpu``) or when the ranks share one card (``shared_device``; NCCL
refuses two ranks on one card, and gloo all-reduces CUDA tensors through the
host).  The card is selected with ``torch.cuda.set_device`` before anything
touches it.

Collectives under CUDA graph capture (``utils/graphs.py``): an NCCL group is
bound to the rank's card (``device_id``), which makes its communicator when
the group is made, and every subgroup's with it (``dist.new_group``), so no
communicator is first needed inside a capture, where it cannot be made.
The card's torch (2.11, NCCL 2.27) needs nothing more: its
``ProcessGroupNCCL`` hands a collective made under capture to no watchdog,
and a collective made with ``async_op=False`` makes the capturing stream
wait on its NCCL stream rather than the host, unless
``TORCH_NCCL_BLOCKING_WAIT`` is set, which a capture refuses.  (The CUDA
graph notes of older releases asked for ``TORCH_NCCL_ASYNC_ERROR_HANDLING=0``
before ``init_process_group``; that release's watchdog polled every work.)

Data loading: each rank feeds only its rows of the global batch
(``process_local_batch_slice``, ``parallel/mesh.py::batch_sharding``); nothing
is gathered, where the JAX package assembles a global array
(``make_global_batch``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from hmd_ego_pose_tpu_torch.utils.device import DeviceLike, resolve_device

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
DEFAULT_TIMEOUT_S = 600.0


def launched() -> bool:
    """Whether torchrun's environment names a world of processes."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def local_device(device: DeviceLike = None, shared_device: bool = False) -> torch.device:
    """This rank's device: the CPU when asked for, a card named with its
    index as named, else under torchrun ``cuda:LOCAL_RANK`` (``cuda:0`` for
    every rank when they share one card), and ``cuda`` in a single process."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None or not launched():
        return dev
    index = 0 if shared_device else int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", index)


def backend_for(device: torch.device, shared_device: bool = False) -> str:
    """``gloo`` on the CPU or for ranks sharing a card, else ``nccl``."""
    return "gloo" if device.type == "cpu" or shared_device else "nccl"


def initialize(device: DeviceLike = None, shared_device: bool = False,
               timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group torchrun's environment names.

    No-op (returns False) in a single process, as the JAX package's
    ``initialize``.  Otherwise selects this rank's card, then calls
    ``init_process_group`` with the backend of ``backend_for``, an NCCL
    group bound to the card (module docstring), and a ``timeout`` of seconds
    after which a collective that waits fails; returns True (also when the
    group already exists).  A rank that cannot make its group raises."""
    if not launched():
        return False
    if dist.is_initialized():
        return True
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"torch.distributed environment incomplete: {missing} unset")
    dev = local_device(device, shared_device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(dev, shared_device)
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        world_size=int(os.environ["WORLD_SIZE"]), rank=int(os.environ["RANK"]),
        timeout=datetime.timedelta(seconds=timeout),
        device_id=dev if backend == "nccl" else None,
    )
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_local_batch_slice(global_batch_size: int, world: Optional[int] = None,
                              index: Optional[int] = None) -> slice:
    """The [start, stop) rows of the global batch this process must feed (the
    JAX package's arithmetic; ``world`` and ``index`` default to this
    process's)."""
    world = world_size() if world is None else world
    index = rank() if index is None else index
    per = global_batch_size // world
    start = index * per
    return slice(start, start + per)

