"""NN primitives in NCHW with the reference's TensorFlow-style SAME padding.

Counterpart of ``hmd_ego_pose_tpu/nn/core.py`` (NHWC there):

* SAME padding is asymmetric, the extra pixel on the high side, applied with
  an explicit ``F.pad`` (``padding="same"`` of PyTorch is not this for
  stride 2);
* batch norm: statistics and affine in float32, the result cast to the
  compute dtype, eps 1e-3 by default; in training mode (``module.train()``)
  it normalises with the batch statistics, the variance taken as
  E[x^2] - E[x]^2 as the JAX package takes it, and moves the running
  statistics by momentum 0.01 with the n / (n - 1) correction of the
  variance;
* max-pool pads with zeros, not -inf (the reference's quirk, observable
  through trained weights).

The ``space`` mesh axis (``parallel/spatial.py``).  A module holds a
``mesh`` (``parallel/mesh.py::attach``), and the model passes each call the
height of its input's whole level (``full_h``).  Under a space axis above 1
a level that the axis divides is held as slabs (``DataMesh.sharded``), any
other level whole on every rank of the space group.  A window op (a conv
with k > 1 or stride 2, the max-pool) on slabs takes its SAME padding from
the whole height and its halo rows from the neighbouring slabs; when its
output level is not split it gathers its input first, and an output of a
split level made from a whole input is cut to the slab.  Training-mode BN
reduces a split level's statistics over (data x space).  With no space axis,
or no ``full_h``, every op runs the single-device code.  Each choice is made
on shapes and the mesh's ranks, never on device data, so a CUDA graph
captures these ops with their collectives on a capturable mesh.

Compute dtype.  Parameters stay float32.  With ``dtype=torch.bfloat16`` the
modules round to bfloat16 where the JAX reference, compiled by XLA for the
CPU, rounds; that is what its committed golden outputs were made with, and
the last bf16 bit of a head output is worth 3.9 mm of translation:

* a convolution rounds its input and weights to bf16 and accumulates in
  float32; without bias its output stays float32 (XLA does not round a conv
  output that batch norm upcasts again); with bias, output and bias are
  rounded and added in bf16;
* every elementwise op on bf16 values rounds its result, including each step
  of the sigmoid 1 / (1 + exp(-x));
* ``swish`` returns its final product unrounded (float32): the SE mean
  reads it so, and every other consumer rounds it first.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hmd_ego_pose_tpu_torch.parallel import spatial
from hmd_ego_pose_tpu_torch.parallel.mesh import LOCAL, DataMesh


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF SAME padding (lo, hi) for one spatial dim, extra pixel on the high side."""
    extra = max((math.ceil(size / stride) - 1) * stride - size + kernel, 0)
    lo = extra // 2
    return lo, extra - lo


def pad_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    top, bottom = same_padding(x.shape[-2], kernel, stride)
    left, right = same_padding(x.shape[-1], kernel, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom))


def out_height(full_h: Optional[int], stride: int) -> Optional[int]:
    """The whole height after a SAME window of ``stride`` (None stays None)."""
    return None if full_h is None else -(-full_h // stride)


def window_op(x: torch.Tensor, mesh: DataMesh, full_h: int, kernel: int, stride: int, op) -> torch.Tensor:
    """``op`` (a window op without padding) over ``x`` with SAME padding, on
    the slab or whole level that ``full_h`` and the mesh make ``x``; returns
    the output level as the mesh holds it."""
    out_h = out_height(full_h, stride)
    if mesh.sharded(full_h) and mesh.sharded(out_h):
        top, _ = same_padding(full_h, kernel, stride)
        left, right = same_padding(x.shape[-1], kernel, stride)
        # rows [slab start - top, slab end - stride - top + kernel) of the image
        x = spatial.halo(x, mesh, top, max(kernel - stride - top, 0))
        return op(F.pad(x, (left, right, 0, 0)))
    if mesh.sharded(full_h):
        x = spatial.gather_rows(x, mesh)
    y = op(pad_same(x, kernel, stride))
    return spatial.scatter_rows(y, mesh) if mesh.sharded(out_h) else y


def _spatial(mesh: DataMesh, full_h: Optional[int], what: str) -> bool:
    """Whether an op runs on the space axis: one above 1 needs ``full_h``."""
    if mesh.space == 1:
        return False
    if full_h is None:
        raise ValueError(f"{what} under a space axis of {mesh.space} needs the height of its whole level")
    return True


class Conv2dSame(nn.Module):
    """Conv with SAME padding; ``weight`` (O, I/groups, k, k) and optional ``bias``.

    ``forward(x, full_h)``: ``full_h`` the whole height of ``x``'s level,
    which a window conv needs under a space axis (module docstring)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.stride, self.groups, self.dtype = kernel, stride, groups, dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, kernel, kernel))
        self.register_parameter("bias", nn.Parameter(torch.zeros(cout)) if bias else None)
        self.mesh = LOCAL

    def forward(self, x: torch.Tensor, full_h: Optional[int] = None) -> torch.Tensor:
        if self.kernel == self.stride == 1 or not _spatial(self.mesh, full_h, "a window conv"):
            x = pad_same(x.to(self.dtype), self.kernel, self.stride).float()
            w = self.weight.to(self.dtype).float()
            y = F.conv2d(x, w, None, self.stride, 0, 1, self.groups)
        else:
            w = self.weight.to(self.dtype).float()
            y = window_op(x.to(self.dtype).float(), self.mesh, full_h, self.kernel, self.stride,
                          lambda t: F.conv2d(t, w, None, self.stride, 0, 1, self.groups))
        if self.bias is None:
            return y
        return y.to(self.dtype) + self.bias.to(self.dtype)[:, None, None]


class Wrapped(nn.Module):
    """Holds a conv as ``.conv``: the BiFPN/head key layout (``...conv.weight``)."""

    def __init__(self, conv: Conv2dSame):
        super().__init__()
        self.conv = conv

    def forward(self, x: torch.Tensor, full_h: Optional[int] = None) -> torch.Tensor:
        return self.conv(x, full_h)


class Skip(nn.Identity):
    """An identity that takes the ops' ``full_h`` too: what BN folding leaves
    in a BatchNorm's place (``models/folding.py``)."""

    def forward(self, x: torch.Tensor, full_h: Optional[int] = None) -> torch.Tensor:
        return x


class BatchNorm(nn.Module):
    """Batch norm over NCHW; float32 math, output in the compute dtype.

    Eval mode normalises with the running statistics.  Training mode
    (``batch_norm_apply(training=True)`` of ``hmd_ego_pose_tpu/nn/core.py``)
    normalises with the batch statistics and updates the running ones in
    place: ``new = (1 - m) * running + m * batch``, the variance corrected by
    n / (n - 1) for n = N * H * W.  Parameter names follow
    ``nn.BatchNorm2d`` (weight, bias, running_mean, running_var) so
    state_dict keys match the reference's.

    ``update_stats`` False keeps the running statistics where they are in
    training mode: the recompute of a checkpointed block in the backward pass
    runs its forward a second time, and must not move them twice
    (``models/efficientnet.py``).  It still all-reduces under a mesh: every
    rank recomputes in the same order, so the collectives line up.

    ``mesh`` (a ``parallel/mesh.py::DataMesh``, set by ``replicate``; a mesh
    of one by default): the cross-replica statistics of the JAX package's
    ``axis_name`` path, which is what GSPMD computes for a batch sharded over
    ``data``.  In training mode
    ``[mean, mean_sq]`` of the local rows is all-reduced (mean over the D
    data ranks) in one call, differentiably, and the correction takes the
    global n = D * N * H * W.  A level split over the space axis
    (``forward(x, full_h)``) reduces over the D * S ranks of (data x space),
    n = D * S * N * (H / S) * W: every slab has as many elements, so the
    mean of the means is the mean.
    """

    def __init__(self, channels: int, eps: float = 1e-3, dtype: torch.dtype = torch.float32,
                 momentum: float = 0.01):
        super().__init__()
        self.eps, self.dtype, self.momentum = eps, dtype, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.update_stats = True
        self.mesh = LOCAL
        self.eval()  # an inference module until training asks (``model.train()``)

    def forward(self, x: torch.Tensor, full_h: Optional[int] = None) -> torch.Tensor:
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = (x.float() - self.running_mean[:, None, None]) * inv[:, None, None]
            return (y + self.bias[:, None, None]).to(self.dtype)
        xf = x.float()
        mean = torch.mean(xf, dim=(0, 2, 3))
        mean_sq = torch.mean(xf * xf, dim=(0, 2, 3))
        n = x.shape[0] * x.shape[2] * x.shape[3]
        over = "batch" if _spatial(self.mesh, full_h, "a training BatchNorm") and self.mesh.sharded(full_h) else "data"
        mean, mean_sq = self.mesh.all_reduce_mean([mean, mean_sq], "bn", over)
        n *= self.mesh.world * (self.mesh.space if over == "batch" else 1)
        var = mean_sq - mean * mean
        # float32 n / max(n - 1, 1), as jnp computes it
        correction = float(np.float32(n) / np.float32(max(n - 1.0, 1.0)))
        m = self.momentum
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * var * correction)
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * inv[:, None, None]
        return (y + self.bias[:, None, None]).to(self.dtype)


class _Sigmoid(torch.autograd.Function):
    """1 / (1 + exp(-x)) whose derivative is s (1 - s), as that of the JAX
    package's ``jax.nn.sigmoid`` (``lax.logistic``).  Differentiated op by op,
    the formula's derivative exp(-x) / (1 + exp(-x))^2 is inf / inf, NaN,
    wherever exp(-x) overflows (x below about -88 in float32): a trainable
    backbone reaches such inputs."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        (s,) = ctx.saved_tensors
        return grad * (s * (1.0 - s))


def sigmoid(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """1 / (1 + exp(-x)) in ``dtype``, each step rounded to it; under autograd
    its derivative is s (1 - s) (``_Sigmoid``)."""
    x = x.to(dtype)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Sigmoid.apply(x)
    return 1.0 / (1.0 + torch.exp(-x))


def swish(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x * sigmoid(x); the product is left in float32 (see the module docstring)."""
    x = x.to(dtype)
    return x.float() * sigmoid(x, dtype).float()


def max_pool_same(x: torch.Tensor, kernel: int = 3, stride: int = 2, full_h: Optional[int] = None,
                  mesh: DataMesh = LOCAL) -> torch.Tensor:
    """Max pool after SAME zero padding (border maxima are clamped at >= 0);
    on the space axis as a window conv (module docstring)."""
    if not _spatial(mesh, full_h, "a max-pool"):
        return F.max_pool2d(pad_same(x, kernel, stride), kernel, stride)
    return window_op(x, mesh, full_h, kernel, stride, lambda t: F.max_pool2d(t, kernel, stride))


def resize_nearest_2x(x: torch.Tensor, full_h: Optional[int] = None, mesh: DataMesh = LOCAL) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of NCHW: row by row, so a slab stays the
    slab of the level twice as high; a whole level whose double the space
    axis splits is cut to the slab."""
    y = F.interpolate(x, scale_factor=2, mode="nearest")
    if _spatial(mesh, full_h, "an upsample") and not mesh.sharded(full_h) and mesh.sharded(2 * full_h):
        return spatial.scatter_rows(y, mesh)
    return y
