"""BiFPN cells: fast-attention fusion, first-cell aligners, P6/P7 synthesis.

Counterpart of ``hmd_ego_pose_tpu/models/bifpn.py``.  The first cell
down-channels the backbone's (P3, P4, P5) and makes P6/P7 from P5; each cell
runs a top-down then a bottom-up pass.  Fusion is relu(w) / (sum + eps)
weighted, then swish, for phi < 6, and a plain sum otherwise.

Under a space axis each op is given the whole height of its level
(``heights``, P3 to P7; ``nn/core.py``): a level the axis divides is held as
slabs, a smaller or uneven one (P6 and P7 of a small image) whole on every
rank.  The max-pools gather a split level into a whole one, the upsample
cuts a whole level to the slabs of a split one, so every input of a fusion
is held as its level is.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hmd_ego_pose_tpu_torch.nn.core import (
    BatchNorm, Conv2dSame, Wrapped, max_pool_same, resize_nearest_2x, swish,
)
from hmd_ego_pose_tpu_torch.parallel.mesh import LOCAL

_EDGES = ("conv6_up", "conv5_up", "conv4_up", "conv3_up",
          "conv4_down", "conv5_down", "conv6_down", "conv7_down")
_FUSION_WEIGHTS = (("p6_w1", 2), ("p5_w1", 2), ("p4_w1", 2), ("p3_w1", 2),
                   ("p4_w2", 3), ("p5_w2", 3), ("p6_w2", 3), ("p7_w2", 2))


class SepConv(nn.Module):
    """Depthwise 3x3 (no bias) + pointwise 1x1 (bias) [+ BN], no activation."""

    def __init__(self, cin: int, cout: int, norm: bool = True, eps: float = 1e-3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depthwise_conv = Wrapped(Conv2dSame(cin, cin, 3, groups=cin, bias=False, dtype=dtype))
        self.pointwise_conv = Wrapped(Conv2dSame(cin, cout, 1, dtype=dtype))
        self.bn = BatchNorm(cout, eps, dtype) if norm else None

    def forward(self, x: torch.Tensor, full_h: Optional[int] = None) -> torch.Tensor:
        x = self.pointwise_conv(self.depthwise_conv(x, full_h))
        return x if self.bn is None else self.bn(x, full_h)


def _aligner(cin: int, cout: int, eps: float, dtype: torch.dtype) -> nn.Sequential:
    """1x1 conv + BN down-channelling a backbone feature (keys ``.0.conv``, ``.1``)."""
    return nn.Sequential(Wrapped(Conv2dSame(cin, cout, 1, dtype=dtype)), BatchNorm(cout, eps, dtype))


def _align(aligner: nn.Sequential, x: torch.Tensor, full_h: Optional[int]) -> torch.Tensor:
    return aligner[1](aligner[0](x), full_h)


class BiFPNCell(nn.Module):
    def __init__(self, channels: int, conv_channels: Tuple[int, int, int], first_time: bool,
                 attention: bool = True, eps: float = 1e-3, fusion_eps: float = 1e-4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.first_time, self.attention, self.fusion_eps = first_time, attention, fusion_eps
        self.dtype, self.mesh = dtype, LOCAL
        for name in _EDGES:
            setattr(self, name, SepConv(channels, channels, eps=eps, dtype=dtype))
        if first_time:
            c3, c4, c5 = conv_channels
            for name, cin in (("p3_down_channel", c3), ("p4_down_channel", c4),
                              ("p5_down_channel", c5), ("p5_to_p6", c5),
                              ("p4_down_channel_2", c4), ("p5_down_channel_2", c5)):
                setattr(self, name, _aligner(cin, channels, eps, dtype))
        for name, n in _FUSION_WEIGHTS:
            setattr(self, name, nn.Parameter(torch.ones(n)))

    def _fuse(self, name: str, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        if self.attention:
            w = F.relu(getattr(self, name))
            w = w / (w.sum() + self.fusion_eps)
            out = sum(w[i].to(self.dtype) * t.to(self.dtype) for i, t in enumerate(tensors))
        else:
            out = sum(t.to(self.dtype) for t in tensors)
        return swish(out, self.dtype)

    def forward(self, features: Sequence[torch.Tensor], heights: Optional[Sequence[int]] = None
                ) -> Tuple[torch.Tensor, ...]:
        """``heights``: the whole heights of P3..P7 (needed under a space axis)."""
        h3, h4, h5, h6, h7 = heights if heights is not None else (None,) * 5
        mesh = self.mesh

        def pool(x, h):
            return max_pool_same(x, full_h=h, mesh=mesh)

        def up(x, h):
            return resize_nearest_2x(x, h, mesh)

        if self.first_time:
            p3, p4, p5 = features
            p6_in = pool(_align(self.p5_to_p6, p5, h5), h5)
            p7_in = pool(p6_in, h6)
            p3_in = _align(self.p3_down_channel, p3, h3)
            p4_in = _align(self.p4_down_channel, p4, h4)
            p5_in = _align(self.p5_down_channel, p5, h5)
        else:
            p3_in, p4_in, p5_in, p6_in, p7_in = features

        p6_up = self.conv6_up(self._fuse("p6_w1", [p6_in, up(p7_in, h7)]), h6)
        p5_up = self.conv5_up(self._fuse("p5_w1", [p5_in, up(p6_up, h6)]), h5)
        p4_up = self.conv4_up(self._fuse("p4_w1", [p4_in, up(p5_up, h5)]), h4)
        p3_out = self.conv3_up(self._fuse("p3_w1", [p3_in, up(p4_up, h4)]), h3)

        if self.first_time:
            p4_in = _align(self.p4_down_channel_2, p4, h4)
            p5_in = _align(self.p5_down_channel_2, p5, h5)

        p4_out = self.conv4_down(self._fuse("p4_w2", [p4_in, p4_up, pool(p3_out, h3)]), h4)
        p5_out = self.conv5_down(self._fuse("p5_w2", [p5_in, p5_up, pool(p4_out, h4)]), h5)
        p6_out = self.conv6_down(self._fuse("p6_w2", [p6_in, p6_up, pool(p5_out, h5)]), h6)
        p7_out = self.conv7_down(self._fuse("p7_w2", [p7_in, pool(p6_out, h6)]), h7)
        return p3_out, p4_out, p5_out, p6_out, p7_out


class BiFPN(nn.ModuleList):
    """Stacked cells; a ModuleList so keys read ``bifpn.{i}.*`` as in the reference."""

    def __init__(self, channels: int, conv_channels: Tuple[int, int, int], repeats: int,
                 attention: bool = True, eps: float = 1e-3, fusion_eps: float = 1e-4,
                 dtype: torch.dtype = torch.float32):
        super().__init__([
            BiFPNCell(channels, conv_channels, i == 0, attention, eps, fusion_eps, dtype)
            for i in range(repeats)
        ])

    def forward(self, features, capture: Optional[dict] = None,
                heights: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        for i, cell in enumerate(self):
            features = cell(features, heights)
            if capture is not None:
                for level, feat in enumerate(features):
                    capture[f"bifpn.cell{i}.p{level + 3}"] = feat
        return list(features)
