"""Device selection for the port's entry points, and packed uploads of host trees.

Every entry point takes an explicit ``device``.  ``None`` means the card
(``cuda``); the CPU is used only when the caller asks for it.  A missing
card is an error, never a silent fall back to the CPU.

``pack_transfer`` uploads a host tree with one host-to-device copy per
dtype, as the JAX package's ``utils/device.py::pack_transfer`` does.
``PackedFields`` keeps named fields of several dtypes in one host buffer
(pinned on a card) and one device buffer, uploaded with one asynchronous
copy: the static inputs that a captured CUDA graph reads
(``train/step.py::ResidentGraph``).
``UPLOADS`` counts the host-to-device copies of the restore path by what
made them (``pack_transfer/<dtype>``, ``dequantize_group/values``, ...), in
the style of ``kernels.LAUNCHES``; a copy to the CPU counts as well, so the
CPU tests read the counts the card gives.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from hmd_ego_pose_tpu_torch.kernels import LaunchCounts

DeviceLike = Union[str, torch.device, None]

UPLOADS = LaunchCounts()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for and absent.

    On CUDA it also turns TF32 off for matmuls and cuDNN convolutions: the
    port computes its float32 paths (preprocess resize, fp32 forward) in full
    float32, as the JAX reference does with ``Precision.HIGHEST``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def dtype_of(name: str) -> torch.dtype:
    """``ModelConfig.compute_dtype`` string -> torch dtype."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"unsupported compute dtype {name!r}")
    return dtypes[name]


def _tree_leaves(tree, out: List[Any]) -> List[Any]:
    """The leaves of nested dicts, lists and tuples, in order (dicts by insertion)."""
    if isinstance(tree, dict):
        for v in tree.values():
            _tree_leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tree_leaves(v, out)
    else:
        out.append(tree)
    return out


def _tree_fill(tree, leaves):
    """``tree`` with its leaves taken in order from the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _tree_fill(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_fill(v, leaves) for v in tree)
    return next(leaves)


def pack_transfer(tree, device: DeviceLike = None):
    """A tree of host arrays (numpy or CPU tensors; nested dicts, lists and
    tuples) -> the same tree of tensors on ``device``, with one host-to-device
    copy per dtype.

    Every leaf is raveled into one contiguous host buffer per dtype name, in
    tree order; each buffer is uploaded once (counted in ``UPLOADS``) and cut
    back into the leaves' shapes on the device.  The leaves come back as
    views of their dtype's buffer, not copies: the unpack is
    ``split_with_sizes`` and ``view``, no launch.  That is safe for every
    consumer in the port: the views do not overlap, so a write to one leaf
    touches no other; ``load_state_dict`` copies them into the model's own
    parameters (``from_jax_params`` keeps float32 tensors as they are), the
    int8 save packs them with ``torch.cat`` and the checkpoint writers copy
    them to the host; nothing resizes one.  The optimizer's resumed moments
    are made from the checkpoint's ``opt/`` leaves on the host
    (``train/state.py::load_leaves``), not from these views.  A leaf that
    outlives the others keeps its whole buffer alive (for the shipped
    artifact, 0.52 MB of float32).
    """
    dev = resolve_device(device)
    leaves = [np.asarray(x) for x in _tree_leaves(tree, [])]
    groups = {}  # dtype name -> indices of its leaves, in tree order
    for i, a in enumerate(leaves):
        groups.setdefault(a.dtype.name, []).append(i)
    out: List[Any] = [None] * len(leaves)
    for name, idx in groups.items():
        host = np.concatenate([leaves[i].reshape(-1) for i in idx], dtype=np.dtype(name))
        flat = torch.from_numpy(host).to(dev)
        UPLOADS.add(f"pack_transfer/{name}")
        for i, piece in zip(idx, flat.split_with_sizes([leaves[i].size for i in idx])):
            out[i] = piece.view(leaves[i].shape)
    return _tree_fill(tree, iter(out))


class PackedFields:
    """Named tensors of several dtypes packed into one byte buffer on the host
    (pinned for a CUDA device) and one on ``device``.  The host writes
    ``host[name]``; ``upload()`` copies the whole buffer with one asynchronous
    host-to-device copy; ``fields[name]`` are views of the device buffer, at
    fixed addresses, which a captured graph reads.  ``wait()`` returns once
    the last upload, and whatever the caller queued on the stream before it,
    has been made, so the host may write the host buffers again; on the CPU
    a copy is made at once."""

    def __init__(self, fields: Dict[str, Tuple[Sequence[int], torch.dtype]], device: torch.device):
        self.device = torch.device(device)
        layout, size = {}, 0
        for name, (shape, dtype) in fields.items():
            nbytes = math.prod(shape) * dtype.itemsize
            layout[name] = (size, nbytes, tuple(shape), dtype)
            size += -(-nbytes // 8) * 8  # every field 8-byte aligned
        cuda = self.device.type == "cuda"
        self._host = torch.zeros(size, dtype=torch.uint8, pin_memory=cuda)
        self._device = torch.zeros(size, dtype=torch.uint8, device=self.device)

        def views(buffer):
            return {name: buffer[o:o + n].view(dtype).view(shape) for name, (o, n, shape, dtype) in layout.items()}

        self.host, self._fields = views(self._host), views(self._device)
        self._copied = torch.cuda.Event() if cuda else None

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._fields[name]

    def wait(self) -> None:
        if self._copied is not None:
            self._copied.synchronize()

    def upload(self) -> None:
        self._device.copy_(self._host, non_blocking=True)
        if self._copied is not None:
            with torch.cuda.device(self.device):
                self._copied.record()
