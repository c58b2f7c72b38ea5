"""Per-channel int8 quantize and dequantize: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``hmd_ego_pose_tpu/ops/quantization.py``:

* ``dequantize`` replaces the TPU kernel ``dequantize_pallas`` (an (R, C)
  int8 array times a row of C float32 scales), and ``dequantize_reference``
  is its plain PyTorch version.  The int8 restore of ``train/checkpoint.py``
  runs every int8 leaf of an artifact through ``dequantize``.
* ``quantize`` replaces the TPU kernel ``quantize_pallas`` ((R, C) float32
  -> int8 values and per-column scales), and ``quantize_reference`` is its
  plain PyTorch version, step for step the JAX package's ``quantize_np``,
  which is what the JAX int8 save runs.  ``quantize_tree`` applies the JAX
  package's leaf rule; the int8 save of ``train/checkpoint.py`` runs every
  large leaf through ``quantize``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
from hmd_ego_pose_tpu_torch.kernels import build


def dequantize_reference(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(R, C) int8 x (C,) or (1, C) float32 -> (R, C) float32, plain PyTorch."""
    return values.to(torch.float32) * scales.reshape(1, -1)


def dequantize(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(R, C) int8 x (C,) or (1, C) float32 scales -> (R, C) float32.

    On a CUDA tensor this launches the hand-written kernel
    (``csrc/dequantize.cu``) on the current stream, or raises: a build or
    launch failure is never hidden behind the plain version.  A tensor on the
    CPU takes the plain version.
    """
    if values.device.type == "cpu" and scales.device.type == "cpu":
        return dequantize_reference(values, scales)
    if values.device.type != "cuda" or scales.device != values.device:
        raise ValueError(
            f"dequantize needs values and scales on one CUDA device, got "
            f"{values.device} and {scales.device}"
        )
    if values.dtype != torch.int8 or values.dim() != 2:
        raise ValueError(f"values must be a 2-D int8 tensor, got {values.dtype} {tuple(values.shape)}")
    rows, cols = values.shape
    if scales.dtype != torch.float32 or scales.numel() != cols or scales.dim() not in (1, 2):
        raise ValueError(
            f"scales must be float32 of shape ({cols},) or (1, {cols}), "
            f"got {scales.dtype} {tuple(scales.shape)}"
        )
    if not (values.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequantize needs contiguous values and scales")
    out = torch.empty((rows, cols), dtype=torch.float32, device=values.device)
    if rows == 0 or cols == 0:
        return out
    lib = build.library("dequantize")
    stream = torch.cuda.current_stream(values.device).cuda_stream
    rc = lib.hegp_dequantize(values.data_ptr(), scales.data_ptr(), out.data_ptr(), rows, cols, stream)
    if rc != 0:
        raise RuntimeError(f"dequantize kernel launch failed: cudaError {rc}")
    LAUNCHES.add("dequantize")
    return out


_MIN_QUANT_SIZE = 1024  # smaller leaves (biases, BN) stay float32, as in the JAX package


def quantize_reference(x2d: torch.Tensor):
    """(R, C) float32 -> ((R, C) int8, (1, C) float32 scales), plain PyTorch.

    Step for step ``quantize_np``: absmax = max(max |x| over rows, 1e-12f),
    scale = absmax / 127 (a division), q = clip(round(x / scale), -127, 127),
    ``torch.round`` rounding half to even as ``np.round`` does.  127 is divided
    as a tensor: on CUDA, PyTorch turns a division by a Python scalar into a
    multiply by its reciprocal, which is not numpy's scale.
    """
    absmax = torch.maximum(x2d.abs().amax(dim=0, keepdim=True),
                           torch.full((), 1e-12, dtype=torch.float32, device=x2d.device))
    scale = absmax / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(x2d / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize(x2d: torch.Tensor):
    """(R, C) float32 -> ((R, C) int8 values, (1, C) float32 scales).

    On a CUDA tensor this launches the hand-written kernel
    (``csrc/quantize.cu``) on the current stream, or raises: a build or
    launch failure is never hidden behind the plain version.  A tensor on the
    CPU takes the plain version.  The kernel is bit-equal to the plain
    version on finite input.  A column holding NaN gets a NaN scale on both
    paths (as in numpy); its int8 values are those of a NaN-to-int8 cast,
    which numpy and torch leave unspecified (0 on the card's kernel).
    """
    if x2d.device.type == "cpu":
        return quantize_reference(x2d)
    if x2d.device.type != "cuda":
        raise ValueError(f"quantize needs a CPU or CUDA tensor, got {x2d.device}")
    if x2d.dtype != torch.float32 or x2d.dim() != 2:
        raise ValueError(f"x must be a 2-D float32 tensor, got {x2d.dtype} {tuple(x2d.shape)}")
    if not x2d.is_contiguous():
        raise ValueError("quantize needs a contiguous tensor")
    rows, cols = x2d.shape
    if rows == 0 or cols == 0:
        raise ValueError(f"quantize needs at least one row and one column, got {(rows, cols)}")
    values = torch.empty((rows, cols), dtype=torch.int8, device=x2d.device)
    scales = torch.empty((1, cols), dtype=torch.float32, device=x2d.device)
    lib = build.library("quantize")
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    rc = lib.hegp_quantize(x2d.data_ptr(), values.data_ptr(), scales.data_ptr(), rows, cols, stream)
    if rc != 0:
        raise RuntimeError(f"quantize kernel launch failed: cudaError {rc}")
    LAUNCHES.add("quantize")
    return values, scales


def host_array(leaf) -> np.ndarray:
    """A leaf as the JAX package's ``np.asarray`` gives it: a tensor as a C-ordered
    array, a numpy array as it is (0-d stays 0-d, Fortran order stays)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous().numpy()
    return np.asarray(leaf)


def quantize_leaf(leaf, device: torch.device) -> Dict[str, np.ndarray]:
    """The JAX package's leaf rule: fewer than 1024 values, or not float32 ->
    ``{"fp32": a}``; otherwise ``{"int8", "scales", "shape"}`` over
    ``reshape(-1, a.shape[-1])``, quantized by ``quantize`` on ``device`` (a
    numpy leaf is uploaded first).  Host numpy arrays come back, with the
    dtypes and shapes the JAX package writes: ``scales`` is (C,), and
    ``shape`` is the tuple of ints, which a checkpoint stores as the 0-d
    int64 members ``shape/0``, ``shape/1``, ..."""
    if isinstance(leaf, torch.Tensor):
        big = leaf.numel() >= _MIN_QUANT_SIZE and leaf.dtype == torch.float32
    else:
        leaf = np.asarray(leaf)
        big = leaf.size >= _MIN_QUANT_SIZE and leaf.dtype == np.float32
    if not big:
        return {"fp32": host_array(leaf)}
    shape = tuple(leaf.shape)
    x = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(leaf))
    values, scales = quantize(x.detach().to(device).reshape(-1, shape[-1]).contiguous())
    return {"int8": values.cpu().numpy().reshape(shape), "scales": scales.cpu().numpy()[0],
            "shape": shape}


def quantize_tree(params, device: torch.device) -> Any:
    """A params tree (nested dicts and lists of tensors or arrays) with every
    leaf packed by ``quantize_leaf``."""
    if isinstance(params, dict):
        return {k: quantize_tree(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [quantize_tree(v, device) for v in params]
    return quantize_leaf(params, device)


def quantized_nbytes(tree) -> int:
    """Bytes of every array of a (packed) tree, as ``np.asarray(leaf).nbytes``."""
    if isinstance(tree, dict):
        return sum(quantized_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(quantized_nbytes(v) for v in tree)
    return host_array(tree).nbytes
