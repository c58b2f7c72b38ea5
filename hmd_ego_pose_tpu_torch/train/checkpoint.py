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
leaves and ``bn/...`` are uploaded one by one.  The metadata sidecar ``<name>.json`` comes back
as a dict.  Orbax directories are not read by the port yet.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from hmd_ego_pose_tpu_torch.config import ModelConfig
from hmd_ego_pose_tpu_torch.ops.quantization import dequantize_group, host_array, quantize_tree
from hmd_ego_pose_tpu_torch.utils.device import DeviceLike, resolve_device


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


def _map_tree(fn, tree, is_leaf):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v, is_leaf) for v in tree]
    return fn(tree)


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
    path = os.path.join(directory, name + ".npz")
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


def _packed(node) -> bool:
    return isinstance(node, dict) and ("fp32" in node or "int8" in node)


def restore_checkpoint(path: str, device: DeviceLike = None) -> Tuple[Any, Any, Dict[str, Any]]:
    """(params, bn_state, metadata): the JAX-layout trees as float32 tensors on ``device``."""
    dev = resolve_device(device)
    if os.path.isdir(path):
        raise NotImplementedError(f"{path}: orbax checkpoints are not read by the PyTorch port")
    with np.load(path) as data:
        files = data.files
        params_flat = {k[len("params/"):]: data[k] for k in files if k.startswith("params/")}
        bn_flat = {k[len("bn/"):]: data[k] for k in files if k.startswith("bn/")}
        int8 = "__format__" in files and str(data["__format__"]) == "int8"

    def upload(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    params = _unflatten(params_flat)
    if int8:
        stored: List[Dict[str, np.ndarray]] = []
        _map_tree(stored.append, params, _packed)
        quantized = [(leaf["int8"].reshape(-1, leaf["int8"].shape[-1]), leaf["scales"])
                     for leaf in stored if "int8" in leaf]
        restored = iter(dequantize_group(quantized, dev) if quantized else ())
        params = _map_tree(lambda leaf: upload(leaf["fp32"]) if "fp32" in leaf
                           else next(restored).reshape(leaf["int8"].shape), params, _packed)
    else:
        params = _map_tree(upload, params, lambda x: isinstance(x, np.ndarray))
    bn_state = _map_tree(upload, _unflatten(bn_flat), lambda x: isinstance(x, np.ndarray))

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
