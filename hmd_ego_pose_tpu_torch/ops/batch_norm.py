"""Training-mode batch norm, with the swish that follows it, as hand-written CUDA kernels.

``nn/core.py::BatchNorm`` normalises with the batch statistics in training
mode.  Two versions of that:

* ``batch_norm_train_reference``, the plain PyTorch version: the formula of
  the JAX package's ``batch_norm_apply(training=True)`` op by op, the
  variance taken as E[x^2] - E[x]^2, the running statistics moved by
  momentum with the n / (n - 1) correction; autograd differentiates it op by
  op.  The CPU and a bfloat16 compute dtype take it (its per-op bf16
  rounding is not the kernels' arithmetic, and no training path of the card
  runs in bf16 by default);
* ``batch_norm_train``, on float32 CUDA tensors: one ``torch.autograd.Function``
  whose forward and backward launch ``csrc/batch_norm.cu``, the swish fused
  in where ``swish`` asks for it.  The forward is two calls of the library
  without a mesh (the statistics with their finalisation, two kernels; the
  output, one), three with one (the statistics' all-reduce between the sums
  and the finalisation); the backward likewise two or three: the sums of
  the gradient, then dx.  ``kernels.LAUNCHES`` counts the calls.  It saves
  x, weight, bias and four per-channel statistics, where autograd kept
  several activation-sized intermediates.

Both make the same collectives on a mesh (``parallel/mesh.py``): ``[mean,
mean_sq]`` all-reduced as "bn" in the forward, and in the backward, where x
needs a gradient, the two per-channel sums that the gradient of the
statistics is made of, as "bn_backward", the same call and size as the
plain version's backward of its all-reduce.  The kernels equal the plain
version bit for bit in the output given its mean and inv; the statistics
and the gradients are sums in another order (``csrc/batch_norm.cu``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hmd_ego_pose_tpu_torch.kernels import launch
from hmd_ego_pose_tpu_torch.parallel.mesh import DataMesh

THREADS = 256  # a block of csrc/batch_norm.cu (kThreads)
TARGET_BLOCKS = 1024  # the blocks a pass over the channels' chunks aims at
MAX_UNITS_PER_THREAD = 16  # vector loads a thread makes in a chunk, at most


def takes_kernels(device: torch.device, dtype: torch.dtype) -> bool:
    """Whether a training-mode norm of a tensor on ``device`` with compute
    ``dtype`` runs the kernels: a CUDA tensor in float32."""
    return device.type == "cuda" and dtype == torch.float32


def ranks_counted(mesh: DataMesh, over: str) -> int:
    """The ranks whose rows the statistics cover: the data axis, or (data x
    space) for a level split into slabs (``over`` "batch")."""
    return mesh.world * (mesh.space if over == "batch" else 1)


def variance_correction(n: int) -> float:
    """float32 n / max(n - 1, 1), as jnp computes it."""
    return float(np.float32(n) / np.float32(max(n - 1.0, 1.0)))


def batch_norm_train_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                               running_mean: torch.Tensor, running_var: torch.Tensor, eps: float, momentum: float,
                               update_stats: bool, mesh: DataMesh, over: str, dtype: torch.dtype) -> torch.Tensor:
    """The plain version: batch statistics in float32 over N, H, W (and the
    mesh's ranks along ``over``), the running statistics moved in place when
    ``update_stats``, the output cast to ``dtype``."""
    xf = x.float()
    mean = torch.mean(xf, dim=(0, 2, 3))
    mean_sq = torch.mean(xf * xf, dim=(0, 2, 3))
    n = x.shape[0] * x.shape[2] * x.shape[3]
    mean, mean_sq = mesh.all_reduce_mean([mean, mean_sq], "bn", over)
    n *= ranks_counted(mesh, over)
    var = mean_sq - mean * mean
    correction = variance_correction(n)
    m = momentum
    if update_stats:
        with torch.no_grad():
            running_mean.copy_((1 - m) * running_mean + m * mean)
            running_var.copy_((1 - m) * running_var + m * var * correction)
    inv = torch.rsqrt(var + eps) * weight
    y = (xf - mean[:, None, None]) * inv[:, None, None]
    return (y + bias[:, None, None]).to(dtype)


def chunking(units: int, channels: int) -> Tuple[int, int]:
    """(chunks, units per chunk) of a channel's ``units`` vector loads: about
    ``TARGET_BLOCKS`` blocks over the channels, 1 to ``MAX_UNITS_PER_THREAD``
    loads a thread."""
    per_thread = -(-units * channels // (TARGET_BLOCKS * THREADS))
    per = min(max(per_thread, 1), MAX_UNITS_PER_THREAD) * THREADS
    return -(-units // per), per


def _vector(hw: int, *tensors: torch.Tensor) -> int:
    """4 where every plane is whole float4s and each pointer is 16-byte aligned, else 1."""
    return 4 if hw % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


class _BatchNormTrain(torch.autograd.Function):
    """y = (x - mean) * inv + bias [then y * sigmoid(y)] with the batch
    statistics; forward and backward in ``csrc/batch_norm.cu``."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, mesh, over, eps, momentum, update_stats, swish):
        n, c, h, w = x.shape
        hw, count = h * w, n * h * w
        vec = _vector(hw, x)
        chunks, per_chunk = chunking(count // vec, c)
        f32 = dict(dtype=torch.float32, device=x.device)
        partial = torch.empty((c, chunks, 2), **f32)
        stats = torch.empty((4, c), **f32)  # mean, mean_sq, rstd, inv
        live = mesh.reduces(over)
        vectors = (weight.data_ptr(), running_mean.data_ptr(), running_var.data_ptr())
        scalars = (float(eps), float(1 - momentum), float(momentum),
                   variance_correction(count * ranks_counted(mesh, over)))
        launch("batch_norm", "hegp_bn_stats", x.device, x.data_ptr(), partial.data_ptr(), stats.data_ptr(), *vectors,
               n, c, hw, chunks, per_chunk, vec, float(count), *scalars, int(not live), int(update_stats))
        if live:
            mean, mean_sq = mesh.all_reduce_mean([stats[0], stats[1]], "bn", over)
            launch("batch_norm", "hegp_bn_finalize", x.device, mean.data_ptr(), mean_sq.data_ptr(), stats.data_ptr(),
                   *vectors, c, *scalars, int(update_stats))
        y = torch.empty_like(x)
        launch("batch_norm", "hegp_bn_apply", x.device, x.data_ptr(), y.data_ptr(), stats.data_ptr(), bias.data_ptr(),
               n, c, hw, vec, int(swish))
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.mesh, ctx.over, ctx.swish = mesh, over, swish
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, weight, bias, stats = ctx.saved_tensors
        g = grad.contiguous()
        n, c, h, w = x.shape
        hw, count = h * w, n * h * w
        vec = _vector(hw, x, g)
        chunks, per_chunk = chunking(count // vec, c)
        f32 = dict(dtype=torch.float32, device=x.device)
        partial = torch.empty((c, chunks, 2), **f32)
        sums, coef = torch.empty((2, c), **f32), torch.empty((2, c), **f32)
        dweight, dbias = torch.empty(c, **f32), torch.empty(c, **f32)
        need_x = ctx.needs_input_grad[0]
        live = need_x and ctx.mesh.reduces(ctx.over)
        params = (stats.data_ptr(), bias.data_ptr(), weight.data_ptr())
        outs = (dweight.data_ptr(), dbias.data_ptr(), coef.data_ptr())
        launch("batch_norm", "hegp_bn_grad_sums", x.device, x.data_ptr(), g.data_ptr(), *params, partial.data_ptr(),
               sums.data_ptr(), *outs, n, c, hw, chunks, per_chunk, vec, int(ctx.swish), float(count), int(not live))
        if live:
            (mean_sums,) = ctx.mesh.all_reduce_mean([sums], "bn_backward", ctx.over)
            launch("batch_norm", "hegp_bn_grad_coef", x.device, sums.data_ptr(), mean_sums.data_ptr(),
                   stats.data_ptr(), weight.data_ptr(), *outs, c, float(count))
        dx = None
        if need_x:
            dx = torch.empty_like(x)
            launch("batch_norm", "hegp_bn_grad_apply", x.device, x.data_ptr(), g.data_ptr(), dx.data_ptr(),
                   stats.data_ptr(), bias.data_ptr(), coef.data_ptr(), n, c, hw, vec, int(ctx.swish))
        grads = (dx, dweight if ctx.needs_input_grad[1] else None, dbias if ctx.needs_input_grad[2] else None)
        return grads + (None,) * 8


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, eps: float, momentum: float, update_stats: bool, mesh: DataMesh,
                     over: str, swish: bool) -> torch.Tensor:
    """``batch_norm_train_reference`` in float32, then the swish where
    ``swish``, through the kernels: x (N, C, H, W) and the four (C,)
    vectors float32 on one CUDA device.  Differentiable in x, weight and
    bias.  Raises on anything else: a build or launch failure is never hidden
    behind the plain version, which the caller takes for CPU tensors."""
    vectors = (weight, bias, running_mean, running_var)
    if x.dim() != 4 or x.dtype != torch.float32 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty float32 (N, C, H, W) tensor, got {x.dtype} {tuple(x.shape)}")
    if any(v.dtype != torch.float32 or v.shape != (x.shape[1],) or not v.is_contiguous() for v in vectors):
        raise ValueError(f"weight, bias and the running statistics must be contiguous float32 ({x.shape[1]},), got "
                         f"{[(v.dtype, tuple(v.shape)) for v in vectors]}")
    if x.device.type != "cuda" or any(v.device != x.device for v in vectors):
        raise ValueError(f"batch_norm_train needs every tensor on one CUDA device, got "
                         f"{[str(t.device) for t in (x,) + vectors]}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"batch_norm_train takes fewer than 2**31 elements, got {x.numel()}")
    return _BatchNormTrain.apply(x.contiguous(), weight, bias, running_mean, running_var, mesh, over, eps, momentum,
                                 update_stats, swish)
