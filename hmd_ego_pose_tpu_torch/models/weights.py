"""Carry the JAX parameter trees across to the port's state_dict, and back.

``from_jax_params(params, bn_state, config)`` takes the JAX package's
``params`` / ``bn_state`` trees (nested dicts and lists, as a ``.npz``
checkpoint's ``params/...`` and ``bn/...`` keys unflatten to) whose leaves are
numpy arrays or tensors, and returns a state_dict for ``HMDEgoPose`` in the
reference's key naming.  Conv kernels go from HWIO to OIHW (depthwise
(kh, kw, 1, C) -> (C, 1, kh, kw)); BN scale/bias become weight/bias and the
running statistics come from ``bn_state``.

Modelled on ``export_torch_state_dict`` of ``hmd_ego_pose_tpu/models/weights.py``,
with the same key mapping (``build_mapping``).  An int8 artifact must be
dequantized before this transpose: its scales run along the last (HWIO
out-channel) axis, which ``train/checkpoint.py`` does.

``to_jax_params(state_dict, config)`` is the inverse: (params, bn_state) in
the JAX package's layout (HWIO kernels, nested dicts and lists), so the port
saves checkpoints the JAX package restores.  ``jax_leaf_paths`` lists the
params tree's leaves in ``jax.tree.leaves`` order (dict keys sorted, list
items by index), each with its state_dict key: the order of the optimizer
moments in a checkpoint's ``opt/NNNNN`` leaves.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from hmd_ego_pose_tpu_torch.config import ModelConfig
from hmd_ego_pose_tpu_torch.models.efficientnet import block_specs

STATE = "__state__"  # path prefix of entries that live in bn_state


class _Mapper:
    """(torch key, tree path, kind) entries; kind "conv" is transposed."""

    def __init__(self):
        self.entries: List[Tuple[str, Tuple, str]] = []

    def conv(self, prefix: str, path: Tuple, bias: bool = True, wrapped: bool = True):
        stem = f"{prefix}.conv" if wrapped else prefix
        self.entries.append((f"{stem}.weight", path + ("kernel",), "conv"))
        if bias:
            self.entries.append((f"{stem}.bias", path + ("bias",), "vec"))

    def bn(self, prefix: str, params_path: Tuple, state_path: Tuple):
        self.entries.append((f"{prefix}.weight", params_path + ("scale",), "vec"))
        self.entries.append((f"{prefix}.bias", params_path + ("bias",), "vec"))
        self.entries.append((f"{prefix}.running_mean", (STATE,) + state_path + ("mean",), "vec"))
        self.entries.append((f"{prefix}.running_var", (STATE,) + state_path + ("var",), "vec"))

    def sep_conv(self, prefix: str, path: Tuple, norm: bool = True):
        self.conv(f"{prefix}.depthwise_conv", path + ("depthwise",), bias=False)
        self.conv(f"{prefix}.pointwise_conv", path + ("pointwise",))
        if norm:
            self.bn(f"{prefix}.bn", path + ("bn",), path + ("bn",))


def build_mapping(config: ModelConfig) -> _Mapper:
    """The full key mapping for a given phi."""
    m = _Mapper()
    bb = ("backbone",)
    m.conv("backbone_net.model._conv_stem", bb + ("stem_conv",), bias=False, wrapped=False)
    m.bn("backbone_net.model._bn0", bb + ("stem_bn",), bb + ("stem_bn",))
    for i, spec in enumerate(block_specs(config.backbone_coefficient)):
        t, p = f"backbone_net.model._blocks.{i}", bb + ("blocks", i)
        if spec["expand_ratio"] != 1:
            m.conv(f"{t}._expand_conv", p + ("expand_conv",), bias=False, wrapped=False)
            m.bn(f"{t}._bn0", p + ("bn0",), p + ("bn0",))
        m.conv(f"{t}._depthwise_conv", p + ("depthwise_conv",), bias=False, wrapped=False)
        m.bn(f"{t}._bn1", p + ("bn1",), p + ("bn1",))
        if spec["se_ratio"]:
            m.conv(f"{t}._se_reduce", p + ("se_reduce",), wrapped=False)
            m.conv(f"{t}._se_expand", p + ("se_expand",), wrapped=False)
        m.conv(f"{t}._project_conv", p + ("project_conv",), bias=False, wrapped=False)
        m.bn(f"{t}._bn2", p + ("bn2",), p + ("bn2",))

    for i in range(config.fpn_cell_repeats):
        t, p = f"bifpn.{i}", ("bifpn", "cells", i)
        for name in ("conv6_up", "conv5_up", "conv4_up", "conv3_up",
                     "conv4_down", "conv5_down", "conv6_down", "conv7_down"):
            m.sep_conv(f"{t}.{name}", p + (name,))
        if i == 0:
            for name in ("p3_down_channel", "p4_down_channel", "p5_down_channel",
                         "p4_down_channel_2", "p5_down_channel_2", "p5_to_p6"):
                m.conv(f"{t}.{name}.0", p + (name, "conv"))
                m.bn(f"{t}.{name}.1", p + (name, "bn"), p + (name, "bn"))
        for w in ("p6_w1", "p5_w1", "p4_w1", "p3_w1", "p4_w2", "p5_w2", "p6_w2", "p7_w2"):
            m.entries.append((f"{t}.{w}", p + (w,), "vec"))

    levels, repeats = config.num_pyramid_levels, config.head_repeats

    def head(name: str, tree_name: str, headers: Dict[str, str], iter_headers: Tuple[str, ...]):
        p = (tree_name,)
        for j in range(repeats):
            m.sep_conv(f"{name}.conv_list.{j}", p + ("convs", j), norm=False)
        for lv in range(levels):
            for j in range(repeats):
                m.bn(f"{name}.bn_list.{lv}.{j}", p + ("bns", lv, j), p + ("bns", lv, j))
        for torch_h, tree_h in headers.items():
            m.sep_conv(f"{name}.{torch_h}", p + (tree_h,), norm=False)
        if config.iter_steps >= 1 and iter_headers:
            it, ip = f"{name}.iterative_submodel", p + ("iter",)
            for j in range(repeats):
                m.sep_conv(f"{it}.conv_list.{j}", ip + ("convs", j), norm=False)
            for s in range(config.iter_steps):
                for j in range(repeats):
                    m.bn(f"{it}.norm_layer.{s}.{j}", ip + ("bns", s, j), ip + ("bns", s, j))
            for h, torch_h in enumerate(iter_headers):
                m.sep_conv(f"{it}.{torch_h}", ip + ("headers", h), norm=False)

    head("regressor", "regressor", {"header": "header"}, ())
    head("classifier", "classifier", {"header": "header"}, ())
    head("rotation_net", "rotation", {"initial_rotation": "header"}, ("head",))
    head("hand_net", "hand", {"initial_hand_coords": "header"}, ("head",))
    head("translation_net", "translation",
         {"initial_translation_xy": "header_xy", "initial_translation_z": "header_z"},
         ("head_xy", "head_z"))
    return m


def _get(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def from_jax_params(params, bn_state, config: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX-layout trees (numpy arrays or tensors) -> ``HMDEgoPose`` state_dict.

    Tensors keep their device; numpy leaves become CPU tensors.
    """
    out: Dict[str, torch.Tensor] = {}
    for key, path, kind in build_mapping(config).entries:
        value: Any = _get(bn_state, path[1:]) if path[0] == STATE else _get(params, path)
        if isinstance(value, torch.Tensor):
            value = value.to(torch.float32)
        else:
            value = torch.tensor(np.asarray(value), dtype=torch.float32)
        if kind == "conv":
            value = value.permute(3, 2, 0, 1)
        out[key] = value.contiguous()
    return out


def _to_jax_layout(value: torch.Tensor, kind: str) -> torch.Tensor:
    """A state_dict tensor -> its JAX-layout value (OIHW -> HWIO for a conv kernel)."""
    return value.permute(2, 3, 1, 0) if kind == "conv" else value


def _set(tree: Dict, path: Tuple, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _listify(node):
    """Nested dicts whose keys are all ints -> lists, by index."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_listify(node[i]) for i in range(len(node))]
    return {k: _listify(v) for k, v in node.items()}


def to_jax_params(state_dict: Dict[str, torch.Tensor], config: ModelConfig):
    """``HMDEgoPose`` state_dict -> (params, bn_state) trees in the JAX package's
    layout, leaves C-ordered float32 numpy arrays.
    ``to_jax_params(from_jax_params(p, b, c), c)`` gives back ``(p, b)`` exactly.
    """
    params: Dict[str, Any] = {}
    bn_state: Dict[str, Any] = {}
    for key, path, kind in build_mapping(config).entries:
        value = _to_jax_layout(state_dict[key].detach().to(torch.float32), kind)
        value = np.ascontiguousarray(value.cpu().numpy())
        if path[0] == STATE:
            _set(bn_state, path[1:], value)
        else:
            _set(params, path, value)
    return _listify(params), _listify(bn_state)


def _tree_order(path: Tuple) -> Tuple:
    """Sort key of a tree path in ``jax.tree.leaves`` order: dict keys as
    strings, list indices as numbers (``blocks/9`` before ``blocks/10``)."""
    return tuple((1, p) if isinstance(p, int) else (0, p) for p in path)


def jax_leaf_paths(config: ModelConfig, exclude_backbone: bool = False) -> List[Tuple[str, Tuple, str]]:
    """(state_dict key, params path, kind) of every params leaf, in ``jax.tree.leaves``
    order; ``exclude_backbone`` drops the backbone subtree (the frozen leaves)."""
    entries = [e for e in build_mapping(config).entries if e[1][0] != STATE]
    if exclude_backbone:
        entries = [e for e in entries if e[1][0] != "backbone"]
    return sorted(entries, key=lambda e: _tree_order(e[1]))


def widen_classes(params, num_classes: int):
    """A one-class model's JAX-layout ``params`` as a ``num_classes``-class
    model's: the classifier header's last conv (kernel (1, 1, C, A) and bias
    (A,) over A anchors of one class) gets each anchor's class column copied
    to every class (output channel ``a * num_classes + c`` is channel ``a``),
    as numpy; every other leaf is shared with ``params`` (host arrays or CPU
    tensors).  The one rule by which the multi-object training references and
    the card's multi-object run start from the shipped one-class artifact."""
    pointwise = {k: np.repeat(np.asarray(v, np.float32), num_classes, axis=-1)
                 for k, v in params["classifier"]["header"]["pointwise"].items()}
    header = {**params["classifier"]["header"], "pointwise": pointwise}
    return {**params, "classifier": {**params["classifier"], "header": header}}
