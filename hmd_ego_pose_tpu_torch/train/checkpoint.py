"""Save and restore ``.npz`` checkpoints in the JAX package's layout.

Counterpart of ``hmd_ego_pose_tpu/train/checkpoint.py``.

``save_checkpoint`` writes what the JAX package's npz backend writes for the
same trees: the members ``params/...``, ``bn/...`` and ``opt/NNNNN`` in that
order, dict keys sorted and list items by index (``blocks/9`` before
``blocks/10``), each array as ``np.asarray`` gives it, through the same
``np.savez`` call, so the files are byte-equal; and the JSON sidecar ``<name>.json``.  The int8
backend writes the JAX package's int8 distribution format: ``__format__``
first, then every params leaf packed by the JAX leaf rule
(``ops/quantization.quantize_tree``: small or non-float32 leaves as
``fp32``, the others as ``int8``, ``scales`` and ``shape``), the large leaves
quantized on the card by the CUDA kernel as one group (one launch for all of
them), then ``bn/...``; for C-ordered trees the file is byte-equal to the JAX
package's.

``restore_checkpoint`` reads the two ``.npz`` formats: plain float32, and int8 (``__format__ == "int8"``,
each large leaf stored as int8 values plus float32 per-channel scales along
its last axis).  Every int8 leaf, in tree order, is dequantized by one
``ops/quantization.dequantize_group``: the values and the scales packed on
the host, uploaded once each and dequantized on the card by the CUDA kernel
in one launch; the leaves come back as views of one buffer.  The float32
leaves and ``bn/...`` go up packed, one copy per dtype
(``utils/device.py::pack_transfer``), also as views of one buffer.  The
metadata sidecar ``<name>.json`` comes back as a dict.  Orbax directories
are not read by the port yet.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from hmd_ego_pose_tpu_torch.config import ModelConfig
from hmd_ego_pose_tpu_torch.ops.quantization import dequantize_group, host_array, quantize_tree
from hmd_ego_pose_tpu_torch.utils.device import DeviceLike, pack_transfer, resolve_device


def _unflatten(flat: Dict[str, Any]):
    """``a/b/0/c`` keys -> nested dicts, with all-digit levels as lists."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts (keys sorted) and lists (by index) -> {"a/b/0/c": leaf}."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix.rstrip("/"): tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def checkpoint_name(dataset: str, fold: int, iters: int, metric: float, epoch: int) -> str:
    """Metric-encoded name, the reference's filename pattern."""
    return f"{dataset}__fold_{fold}__iter_{iters}__mixed_t_mean_{metric:.2f}__epo_{epoch}"


def checkpoint_path(directory: str, name: str) -> str:
    """Where ``save_checkpoint(directory, name, ...)`` writes its ``.npz``."""
    return os.path.join(directory, name + ".npz")


def save_checkpoint(directory: str, name: str, params, bn_state,
                    metadata: Optional[Dict[str, Any]] = None, backend: str = "npz",
                    opt_leaves: Optional[List[Any]] = None, device: DeviceLike = None) -> str:
    """Write ``<directory>/<name>.npz`` and its sidecar; returns the ``.npz`` path.

    ``params`` / ``bn_state``: JAX-layout trees (``models/weights.py::to_jax_params``)
    of numpy arrays or tensors.  ``backend``: "npz" (float32, as given) or
    "int8" (the distribution format; its leaves are quantized on ``device``,
    where None means the card and a missing card raises).  ``opt_leaves``:
    the optimizer state's leaves in ``jax.tree.leaves`` order
    (``train/state.py``), stored as ``opt/00000`` ... by the npz backend so
    either package resumes the run; the int8 backend does not write them, as
    in the JAX package.
    """
    if backend not in ("npz", "int8"):
        raise NotImplementedError(f"checkpoint backend {backend!r} is not ported (npz and int8 only)")
    int8 = backend == "int8"
    flat: Dict[str, Any] = {"__format__": np.asarray("int8")} if int8 else {}
    packed = quantize_tree(params, resolve_device(device)) if int8 else params
    flat.update({"params/" + k: host_array(v) for k, v in _flatten(packed).items()})
    flat.update({"bn/" + k: host_array(v) for k, v in _flatten(bn_state).items()})
    for i, leaf in enumerate(() if int8 else opt_leaves or ()):
        flat[f"opt/{i:05d}"] = host_array(leaf)
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, name)
    np.savez(path, **flat)
    with open(os.path.join(directory, name + ".json"), "w") as f:
        json.dump(metadata or {}, f, indent=2)
    return path


def restore_opt_leaves(path: str) -> Optional[List[np.ndarray]]:
    """The optimizer-state leaves saved beside an npz checkpoint, in
    ``jax.tree.leaves`` order (host numpy); None if it has none."""
    if os.path.isdir(path):
        return None
    with np.load(path) as data:
        keys = sorted(k for k in data.files if k.startswith("opt/"))
        return [data[k] for k in keys] if keys else None


def meta_hand_relative(metadata: Dict[str, Any]) -> Optional[bool]:
    """The hand-decode convention recorded in a checkpoint's sidecar, or None.

    The explicit ``hand_relative`` key first; older sidecars only carry the
    config's repr.
    """
    if "hand_relative" in metadata:
        return bool(metadata["hand_relative"])
    cfg = metadata.get("config")
    if isinstance(cfg, str):
        if "hand_relative=True" in cfg:
            return True
        if "hand_relative=False" in cfg:
            return False
    return None


def restore_checkpoint(path: str, device: DeviceLike = None) -> Tuple[Any, Any, Dict[str, Any]]:
    """(params, bn_state, metadata): the JAX-layout trees as tensors on ``device``.

    The float32 leaves (``params/...`` of an npz file, the ``fp32`` leaves of
    an int8 file, and ``bn/...``) go up in one ``utils/device.py::pack_transfer``
    (one copy per dtype); the int8 leaves in one ``dequantize_group``.
    """
    dev = resolve_device(device)
    if os.path.isdir(path):
        raise NotImplementedError(f"{path}: orbax checkpoints are not read by the PyTorch port")
    with np.load(path) as data:
        files = data.files
        int8 = "__format__" in files and str(data["__format__"]) == "int8"
        flat = {k: data[k] for k in files if k.startswith(("params/", "bn/"))}

    names: List[str] = []  # every leaf, in file order
    host: Dict[str, np.ndarray] = {}
    quantized: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for key, value in flat.items():
        if int8 and key.startswith("params/"):
            name, _, member = key.rpartition("/")
            if member == "fp32":
                host[name] = value
            elif member == "int8":
                quantized[name] = (value, flat[name + "/scales"])
            else:
                continue  # the scales and shape members of an int8 leaf
        else:
            name = key
            host[name] = value
        names.append(name)
    tensors = pack_transfer(host, dev)
    if quantized:
        # stored int8 arrays may be Fortran-ordered: reshape gives row-major (R, C)
        restored = dequantize_group([(v.reshape(-1, v.shape[-1]), sc) for v, sc in quantized.values()], dev)
        tensors.update({name: r.view(v.shape) for (name, (v, _)), r in zip(quantized.items(), restored)})
    params = _unflatten({n[len("params/"):]: tensors[n] for n in names if n.startswith("params/")})
    bn_state = _unflatten({n[len("bn/"):]: tensors[n] for n in names if n.startswith("bn/")})

    metadata: Dict[str, Any] = {}
    meta_path = path[: -len(".npz")] + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    return params, bn_state, metadata


def load_model(path: str, config: ModelConfig, device: DeviceLike = None):
    """Restore ``path`` into an eval-mode ``HMDEgoPose`` on ``device``; returns (model, metadata)."""
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
    from hmd_ego_pose_tpu_torch.models.weights import from_jax_params

    dev = resolve_device(device)
    params, bn_state, metadata = restore_checkpoint(path, dev)
    model = HMDEgoPose(config).to(dev).eval()
    model.load_state_dict(from_jax_params(params, bn_state, config), strict=True)
    return model, metadata
