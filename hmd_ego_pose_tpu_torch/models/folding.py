"""Fold eval-mode batch norms into the convolutions before them, for serving.

Counterpart of ``hmd_ego_pose_tpu/models/folding.py``:
W' = W * s and b' = (b - mean) * s + beta with s = gamma / sqrt(var + eps),
per output channel.  Folded: the backbone stem and every MBConv conv, the
BiFPN separable convs and channel aligners.  Head BNs stay: their convs are
shared across pyramid levels while each level has its own BN.  The JAX
version leaves an identity BN in place; here the BN module is replaced by
``nn/core.py::Skip`` (an ``nn.Identity`` that takes the ops' ``full_h`` too,
and applies the swish a BN's ``activate`` asked for), so the served graph
skips it.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
from hmd_ego_pose_tpu_torch.nn.core import BatchNorm, Conv2dSame, Skip


@torch.no_grad()
def _fold_into(conv: Conv2dSame, bn: BatchNorm) -> None:
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    bias = conv.bias if conv.bias is not None else torch.zeros_like(scale)
    conv.weight.mul_(scale[:, None, None, None])
    conv.bias = nn.Parameter((bias - bn.running_mean) * scale + bn.bias)


def fold_batch_norms(model: HMDEgoPose) -> HMDEgoPose:
    """A copy of ``model`` with conv+BN pairs folded (inference only)."""
    model = copy.deepcopy(model)
    net = model.backbone_net.model
    _fold_into(net._conv_stem, net._bn0)
    net._bn0 = Skip(net._bn0.dtype)
    for block in net._blocks:
        pairs = [("_depthwise_conv", "_bn1"), ("_project_conv", "_bn2")]
        if hasattr(block, "_expand_conv"):
            pairs.append(("_expand_conv", "_bn0"))
        for conv_name, bn_name in pairs:
            _fold_into(getattr(block, conv_name), getattr(block, bn_name))
            setattr(block, bn_name, Skip(block.dtype))
    for cell in model.bifpn:
        for name, child in cell.named_children():
            if isinstance(child, nn.Sequential):  # channel aligner: (conv, BN)
                _fold_into(child[0].conv, child[1])
                child[1] = Skip(child[1].dtype)
            elif getattr(child, "bn", None) is not None:  # separable conv block
                _fold_into(child.pointwise_conv.conv, child.bn)
                child.bn = None
    return model
