"""EfficientNet backbone (B0..B7), NCHW, (P3, P4, P5) features.

Counterpart of ``hmd_ego_pose_tpu/models/efficientnet.py``.  Module and
parameter names follow the reference's state_dict (``_conv_stem``,
``_blocks.{i}._expand_conv`` ...), so ``models/weights.py`` maps the JAX
trees onto them key for key.  Features are the outputs of the last blocks of
stages 3, 5 and 7.

Drop-connect (stochastic depth) runs in training mode on the residual
blocks, at rate 0.2 * i / blocks for block i, when the forward is given a
``torch.Generator`` or the uniforms it would draw (``drop``): the JAX
package draws its masks from ``jax.random``, which torch cannot reproduce,
so the masks come from the generator (or are handed to ``MBConv`` as they
are, as the tests do).  ``drop_connect_uniforms`` is the one draw, of every
block at once: a caller that draws it ahead (the train step's CUDA graph,
whose forward may make no upload) passes the same values the forward would
have drawn.  Without either it is off, as with ``rng=None`` in JAX.  Under a
data-parallel mesh (``mesh``) every rank draws the masks of the global batch
and takes its rows' columns, so a rank drops what one process would drop
for those rows; every space rank of a data row draws the same masks.

Under a space axis (``parallel/spatial.py``) the forward takes the rank's
slab of the image rows and the whole height (``full_h``), and passes each
op the whole height of its level (``nn/core.py``); the squeeze-excite mean
over a split level is the space group's sum over the whole H x W.

``remat`` (``ModelConfig.remat_backbone``) wraps each MBConv block of a
training forward in ``torch.utils.checkpoint`` (non-reentrant): the block
keeps only its inputs, its drop-connect mask among them, and runs again in
the backward pass.  The recompute leaves the BN running statistics alone
(``BatchNorm.update_stats``), so they move once per step, as without remat;
outputs and gradients are those of the plain forward.  The checkpoint does
not save and restore the RNG states (``preserve_rng_state=False``): a block
draws no randomness, its drop-connect mask being an input computed from
uniforms drawn before the blocks run, and the CUDA generator's state cannot
be read while a CUDA graph is being captured, so a captured train step
(``train/step.py::ResidentGraph``) holds the recompute.  The call count that
decides which call moves the statistics is Python's: a capture runs that
Python once, so the graph records one forward that moves them and one
recompute that does not, and each replay moves them once.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint

from hmd_ego_pose_tpu_torch.config import EFFICIENTNET_PARAMS, MBCONV_STAGES
from hmd_ego_pose_tpu_torch.nn.core import BatchNorm, Conv2dSame, out_height, sigmoid, swish
from hmd_ego_pose_tpu_torch.parallel import spatial
from hmd_ego_pose_tpu_torch.parallel.mesh import LOCAL

_FEATURE_STAGES = (3, 5, 7)
DROP_CONNECT_RATE = 0.2


def round_filters(filters: int, width_coefficient: float, divisor: int = 8) -> int:
    """Width scaling with 8-divisor snapping."""
    if not width_coefficient:
        return filters
    filters *= width_coefficient
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: float) -> int:
    if not depth_coefficient:
        return repeats
    return int(math.ceil(depth_coefficient * repeats))


def block_specs(coefficient: int) -> List[Dict[str, Any]]:
    """Expanded per-block spec list for a compound coefficient."""
    width, depth, _res, _drop = EFFICIENTNET_PARAMS[coefficient]
    blocks = []
    for stage_idx, (num_repeat, kernel, stride, expand, cin, cout, se) in enumerate(MBCONV_STAGES):
        cin_r = round_filters(cin, width)
        cout_r = round_filters(cout, width)
        for r in range(round_repeats(num_repeat, depth)):
            blocks.append(dict(
                stage=stage_idx + 1,
                kernel=kernel,
                stride=stride if r == 0 else 1,
                expand_ratio=expand,
                in_ch=cin_r if r == 0 else cout_r,
                out_ch=cout_r,
                se_ratio=se,
            ))
    return blocks


def drop_connect_uniforms(generator: torch.Generator, blocks: int, batch: int) -> torch.Tensor:
    """One training forward's drop-connect uniforms, (blocks, batch) on the
    generator's device: block i keeps example b where ``u[i, b] < keep_i``."""
    return torch.rand((blocks, batch), generator=generator, device=generator.device)


class MBConv(nn.Module):
    """Inverted-residual block with squeeze-excitation."""

    def __init__(self, spec: Dict[str, Any], eps: float, dtype: torch.dtype):
        super().__init__()
        self.spec, self.dtype = spec, dtype
        cin, cout, expand = spec["in_ch"], spec["out_ch"], spec["expand_ratio"]
        mid = cin * expand
        if expand != 1:
            self._expand_conv = Conv2dSame(cin, mid, 1, bias=False, dtype=dtype)
            self._bn0 = BatchNorm(mid, eps, dtype)
        self._depthwise_conv = Conv2dSame(mid, mid, spec["kernel"], stride=spec["stride"],
                                          groups=mid, bias=False, dtype=dtype)
        self._bn1 = BatchNorm(mid, eps, dtype)
        if spec["se_ratio"]:
            se_ch = max(1, int(cin * spec["se_ratio"]))
            self._se_reduce = Conv2dSame(mid, se_ch, 1, dtype=dtype)
            self._se_expand = Conv2dSame(se_ch, mid, 1, dtype=dtype)
        self._project_conv = Conv2dSame(mid, cout, 1, bias=False, dtype=dtype)
        self._bn2 = BatchNorm(cout, eps, dtype)
        self.mesh = LOCAL

    def forward(self, x: torch.Tensor, keep_mask: Optional[torch.Tensor] = None,
                keep_prob: float = 1.0, full_h: Optional[int] = None) -> torch.Tensor:
        """``keep_mask``: (B,) bool drop-connect mask of a residual block, kept
        with probability ``keep_prob``; None runs the block whole.  ``full_h``:
        the whole height of ``x``'s level (``nn/core.py``)."""
        dt, inputs = self.dtype, x
        out_h = out_height(full_h, self.spec["stride"])
        if self.spec["expand_ratio"] != 1:
            x = self._bn0(self._expand_conv(x), full_h, activate=True)
        x = self._bn1(self._depthwise_conv(x, full_h), out_h, activate=True)
        if self.spec["se_ratio"]:
            if out_h is not None and self.mesh.sharded(out_h):
                se = (spatial.space_sum(x.sum(dim=(2, 3), keepdim=True), self.mesh)
                      / (out_h * x.shape[3])).to(dt)
            else:
                se = x.mean(dim=(2, 3), keepdim=True).to(dt)
            se = self._se_expand(swish(self._se_reduce(se), dt))
            x = sigmoid(se, dt) * x.to(dt)
        x = self._bn2(self._project_conv(x), out_h)
        if self.residual:
            if keep_mask is not None:
                x = x / keep_prob * keep_mask[:, None, None, None].to(x.dtype)
            x = x + inputs.to(dt)
        return x

    @property
    def residual(self) -> bool:
        return self.spec["stride"] == 1 and self.spec["in_ch"] == self.spec["out_ch"]


def _first_call_moves_stats(block: MBConv, keep_prob: float, full_h: Optional[int]):
    """``block`` as a function for ``checkpoint``: its first call (the forward)
    moves the BN running statistics, later calls (the recompute) do not."""
    calls = [0]
    norms = [m for m in block.modules() if isinstance(m, BatchNorm)]

    def run(x: torch.Tensor, keep_mask: Optional[torch.Tensor]) -> torch.Tensor:
        calls[0] += 1
        for bn in norms:
            bn.update_stats = calls[0] == 1
        try:
            return block(x, keep_mask, keep_prob, full_h)
        finally:
            for bn in norms:
                bn.update_stats = True

    return run


class EfficientNet(nn.Module):
    def __init__(self, coefficient: int = 0, eps: float = 1e-3, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.specs, self.dtype, self.remat = block_specs(coefficient), dtype, remat
        self.mesh = LOCAL  # a DataMesh: drop-connect masks drawn for the global batch
        stem = round_filters(32, EFFICIENTNET_PARAMS[coefficient][0])
        self._conv_stem = Conv2dSame(3, stem, 3, stride=2, bias=False, dtype=dtype)
        self._bn0 = BatchNorm(stem, eps, dtype)
        self._blocks = nn.ModuleList([MBConv(s, eps, dtype) for s in self.specs])

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                full_h: Optional[int] = None, drop: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``full_h``: the whole image height, of which ``x`` holds the rank's
        rows under a space axis.  ``drop``: the drop-connect uniforms drawn
        ahead (``drop_connect_uniforms``), in place of ``generator``."""
        h = out_height(full_h, 2)
        x = self._bn0(self._conv_stem(x, full_h), h, activate=True)
        n_blocks = len(self.specs)
        draws = None
        if self.training and (drop is not None or generator is not None):
            # every block's uniforms in one draw and one copy to the device;
            # under a mesh the global batch's, of which this rank takes its columns
            if drop is None:
                drop = drop_connect_uniforms(generator, n_blocks, x.shape[0] * self.mesh.world)
            draws = drop[:, self.mesh.rows(drop.shape[1])].to(x.device)
        features = []
        for i, (block, spec) in enumerate(zip(self._blocks, self.specs)):
            keep = 1.0 - DROP_CONNECT_RATE * i / n_blocks
            mask = draws[i] < keep if draws is not None and block.residual and keep < 1.0 else None
            if self.remat and self.training:
                x = torch.utils.checkpoint.checkpoint(_first_call_moves_stats(block, keep, h), x, mask,
                                                      use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x, mask, keep, h)
            h = out_height(h, spec["stride"])
            last_of_stage = i + 1 == len(self.specs) or self.specs[i + 1]["stage"] != spec["stage"]
            if last_of_stage and spec["stage"] in _FEATURE_STAGES:
                features.append(x)
        p3, p4, p5 = features
        return p3, p4, p5


class Backbone(nn.Module):
    """Holds the network as ``.model`` (the reference's ``backbone_net.model.*`` keys)."""

    def __init__(self, coefficient: int = 0, eps: float = 1e-3, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.model = EfficientNet(coefficient, eps, dtype, remat)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                full_h: Optional[int] = None, drop: Optional[torch.Tensor] = None):
        return self.model(x, generator, full_h, drop)
