"""Anchor heads: box, class, rotation, translation and hand.

Counterpart of ``hmd_ego_pose_tpu/models/heads.py``.  Each head runs
``repeats`` separable convs whose weights are shared across pyramid levels,
each followed by that level's own BN and swish, then a separable-conv header
to ``num_anchors * out_dim`` channels.  Outputs are flattened in NHWC order
(location, then anchor, then component), so the NCHW map is permuted to NHWC
before the reshape; anchors then line up with ``ops/anchors.py``.  The
translation head has separate xy (2) and z (1) headers.  With
``iter_steps >= 1`` a refinement subnet regresses deltas onto the header's
prediction.

Under a space axis every op of a level gets the level's whole height
(``heights``; ``nn/core.py``), and each head output of a level held as
slabs is gathered whole before ``flatten_anchors``, so the anchors keep the
order of ``ops/anchors.py`` and the outputs are whole on every rank.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from hmd_ego_pose_tpu_torch.models.bifpn import SepConv
from hmd_ego_pose_tpu_torch.nn.core import BatchNorm
from hmd_ego_pose_tpu_torch.parallel import spatial
from hmd_ego_pose_tpu_torch.parallel.mesh import LOCAL

CLASSIFIER_BIAS_PRIOR = -4.59511985013459  # -log((1 - 0.01) / 0.01)


def flatten_anchors(x: torch.Tensor, out_dim: int) -> torch.Tensor:
    """(B, A*D, H, W) -> (B, H*W*A, D)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, out_dim)


def _bn_grid(rows: int, repeats: int, channels: int, eps: float, dtype: torch.dtype) -> nn.ModuleList:
    return nn.ModuleList([
        nn.ModuleList([BatchNorm(channels, eps, dtype) for _ in range(repeats)]) for _ in range(rows)
    ])


class IterSubnet(nn.Module):
    """Delta regression over concat(feature, predictions), BN per step.

    One subnet, and so one BN per step and repeat, serves every pyramid
    level.  In training the JAX package applies it to each level from the
    step's starting statistics and keeps the last level's update
    (``head_apply``): the caller passes ``update_stats`` True on the last
    level only, so the running statistics move once, from the last level's
    batch statistics.
    """

    def __init__(self, channels: int, concat_ch: int, header_names: Sequence[str],
                 header_dims: Sequence[int], repeats: int, steps: int, eps: float,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv_list = nn.ModuleList([
            SepConv(concat_ch if j == 0 else channels, channels, norm=False, dtype=dtype)
            for j in range(repeats)
        ])
        self.norm_layer = _bn_grid(steps, repeats, channels, eps, dtype)
        self.header_names = tuple(header_names)
        for name, dim in zip(header_names, header_dims):
            setattr(self, name, SepConv(channels, dim, norm=False, dtype=dtype))

    def forward(self, feat: torch.Tensor, preds: List[torch.Tensor], update_stats: bool = True,
                full_h: Optional[int] = None) -> List[torch.Tensor]:
        preds = list(preds)
        for bns in self.norm_layer:
            x = torch.cat([t.to(self.dtype) for t in [feat] + preds], dim=1)
            for conv, bn in zip(self.conv_list, bns):
                keep, bn.update_stats = bn.update_stats, bn.update_stats and update_stats
                try:
                    x = bn(conv(x, full_h), full_h, activate=True)
                finally:
                    bn.update_stats = keep
            for h, name in enumerate(self.header_names):
                preds[h] = preds[h] + getattr(self, name)(x, full_h)
        return preds


class _HeadCore(nn.Module):
    def __init__(self, channels: int, repeats: int, levels: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv_list = nn.ModuleList([
            SepConv(channels, channels, norm=False, dtype=dtype) for _ in range(repeats)
        ])
        self.bn_list = _bn_grid(levels, repeats, channels, eps, dtype)
        self.mesh = LOCAL

    def core(self, feat: torch.Tensor, level: int, full_h: Optional[int] = None) -> torch.Tensor:
        for conv, bn in zip(self.conv_list, self.bn_list[level]):
            feat = bn(conv(feat, full_h), full_h, activate=True)
        return feat

    def whole(self, x: torch.Tensor, full_h: Optional[int]) -> torch.Tensor:
        """A level's output, gathered whole when the space axis splits the level."""
        if full_h is not None and self.mesh.sharded(full_h):
            return spatial.gather_rows(x, self.mesh)
        return x


class Head(_HeadCore):
    """Regressor / classifier / rotation / hand head -> (B, N, out_dim)."""

    def __init__(self, channels: int, out_dim: int, num_anchors: int, repeats: int, levels: int,
                 header_name: str = "header", iter_steps: int = 0, eps: float = 1e-3,
                 dtype: torch.dtype = torch.float32):
        super().__init__(channels, repeats, levels, eps, dtype)
        self.out_dim, self.header_name = out_dim, header_name
        setattr(self, header_name, SepConv(channels, num_anchors * out_dim, norm=False, dtype=dtype))
        if iter_steps >= 1:
            self.iterative_submodel = IterSubnet(
                channels, channels + num_anchors * out_dim, ("head",),
                (num_anchors * out_dim,), repeats, iter_steps, eps, dtype,
            )

    def forward(self, features: Sequence[torch.Tensor], heights: Optional[Sequence[int]] = None) -> torch.Tensor:
        outs = []
        for level, feat in enumerate(features):
            h = None if heights is None else heights[level]
            feat = self.core(feat, level, h)
            pred = getattr(self, self.header_name)(feat, h)
            if hasattr(self, "iterative_submodel"):
                (pred,) = self.iterative_submodel(feat, [pred], level == len(features) - 1, h)
            outs.append(flatten_anchors(self.whole(pred, h), self.out_dim))
        return torch.cat(outs, dim=1)


class TranslationHead(_HeadCore):
    """Separate xy / z headers, concatenated per anchor -> (B, N, 3)."""

    def __init__(self, channels: int, num_anchors: int, repeats: int, levels: int,
                 iter_steps: int = 0, eps: float = 1e-3, dtype: torch.dtype = torch.float32):
        super().__init__(channels, repeats, levels, eps, dtype)
        self.initial_translation_xy = SepConv(channels, num_anchors * 2, norm=False, dtype=dtype)
        self.initial_translation_z = SepConv(channels, num_anchors, norm=False, dtype=dtype)
        if iter_steps >= 1:
            self.iterative_submodel = IterSubnet(
                channels, channels + num_anchors * 3, ("head_xy", "head_z"),
                (num_anchors * 2, num_anchors), repeats, iter_steps, eps, dtype,
            )

    def forward(self, features: Sequence[torch.Tensor], heights: Optional[Sequence[int]] = None) -> torch.Tensor:
        outs = []
        for level, feat in enumerate(features):
            h = None if heights is None else heights[level]
            feat = self.core(feat, level, h)
            xy = self.initial_translation_xy(feat, h)
            z = self.initial_translation_z(feat, h)
            if hasattr(self, "iterative_submodel"):
                xy, z = self.iterative_submodel(feat, [xy, z], level == len(features) - 1, h)
            if h is not None and self.mesh.sharded(h):  # one gather of both
                xy, z = self.whole(torch.cat([xy, z], dim=1), h).split([xy.shape[1], z.shape[1]], dim=1)
            outs.append(torch.cat([flatten_anchors(xy, 2), flatten_anchors(z, 1)], dim=-1))
        return torch.cat(outs, dim=1)
