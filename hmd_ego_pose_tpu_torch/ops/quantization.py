"""Per-channel int8 quantize and dequantize: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``hmd_ego_pose_tpu/ops/quantization.py``:

* ``dequantize_group`` replaces the TPU kernel ``dequantize_pallas`` (an
  (R, C) int8 array times a row of C float32 scales) for a whole group of
  leaves: one upload of the packed values, of the packed scales and of the
  table, one launch of ``csrc/dequantize.cu``.  ``dequantize_reference`` is
  the plain version of one leaf, ``dequantize_group_reference`` walks a
  group's table over it.  The int8 restore of ``train/checkpoint.py`` runs
  every int8 leaf of an artifact through one ``dequantize_group``.
* ``quantize_group`` replaces the TPU kernel ``quantize_pallas`` ((R, C)
  float32 -> int8 values and per-column scales) for a group: one packed
  buffer, one launch of ``csrc/quantize.cu``.  ``quantize_reference`` is the
  plain version of one leaf, step for step the JAX package's ``quantize_np``
  (what the JAX int8 save runs), and ``quantize_group_reference`` walks a
  group's table over it.  ``quantize_tree`` applies the JAX package's leaf
  rule and quantizes every large leaf of a tree as one group.
* ``dequantize`` and ``quantize`` take one leaf: a group of one, over the
  same kernels.

A group lies in flat buffers as ``group_table`` lays it out: one row of six
int64 per leaf (input offset, scales offset, output offset, R, C, first
block; ``csrc/group_table.cuh``).  On a CUDA tensor a wrapper launches its
kernel on the current stream or raises: a build or launch failure is never
hidden behind the plain version.  Tensors on the CPU take the plain version,
through the same packing and table.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from hmd_ego_pose_tpu_torch.kernels import launch
from hmd_ego_pose_tpu_torch.utils.device import UPLOADS

DEQUANTIZE_BLOCK_VALUES = 4096  # values per block of csrc/dequantize.cu: 256 threads x 16
DEQUANTIZE_ALIGN = 16  # a dequantize group starts every leaf at a multiple of 16 values
QUANTIZE_BLOCK_COLS = 32  # columns per block of csrc/quantize.cu


class Group(NamedTuple):
    """How a group of (R, C) leaves lies in packed buffers, and its launch's grid."""

    table: np.ndarray  # (leaves, 6) int64: in offset, scales offset, out offset, R, C, first block
    values: int  # length of the packed value buffers, input and output
    scales: int  # length of the packed scales
    blocks: int  # blocks of the launch


def group_table(shapes: Sequence[Tuple[int, int]], align: int,
                blocks_of: Callable[[np.ndarray, np.ndarray], np.ndarray]) -> Group:
    """The table of a group of (R, C) leaves, in their order.  Each leaf's
    values start at a multiple of ``align`` and have the same offset in the
    input and the output buffer; its scales follow the previous leaf's; its
    blocks (``blocks_of(R, C)``, on arrays) follow the previous leaf's."""
    rows, cols = np.asarray(shapes, np.int64).reshape(-1, 2).T
    sizes = rows * cols
    blocks = blocks_of(rows, cols)
    starts, scales, firsts = (np.concatenate([[0], np.cumsum(a[:-1])]).astype(np.int64)
                              for a in (-(-sizes // align) * align, cols, blocks))
    table = np.stack([starts, scales, starts, rows, cols, firsts], axis=1)
    end = int(starts[-1] + sizes[-1]) if len(sizes) else 0
    return Group(table, end, int(cols.sum()), int(blocks.sum()))


def dequantize_layout(shapes: Sequence[Tuple[int, int]]) -> Group:
    """A dequantize group: leaves 16-aligned, 4,096 values per block."""
    return group_table(shapes, DEQUANTIZE_ALIGN, lambda r, c: -(-r * c // DEQUANTIZE_BLOCK_VALUES))


def quantize_layout(shapes: Sequence[Tuple[int, int]]) -> Group:
    """A quantize group: leaves back to back (one ``torch.cat``), a block per 32 columns."""
    return group_table(shapes, 1, lambda r, c: -(-c // QUANTIZE_BLOCK_COLS))


def _split(flat: torch.Tensor, offsets: np.ndarray, sizes: np.ndarray) -> List[torch.Tensor]:
    """The pieces ``flat[offsets[i]:offsets[i] + sizes[i]]`` (offsets ascending
    from 0), as views, in one ``split_with_sizes``."""
    gaps = np.append(offsets[1:], flat.numel()) - offsets - sizes
    return list(flat.split_with_sizes(np.stack([sizes, gaps], axis=1).reshape(-1).tolist())[::2])


def _launch(name: str, group: Group, table: Optional[torch.Tensor], *buffers: torch.Tensor) -> None:
    """One launch of ``csrc/<name>.cu`` over ``group`` on the current stream;
    ``table`` is ``group.table`` already on the buffers' device, or None to upload it."""
    device = buffers[0].device
    if table is None:
        table = torch.from_numpy(group.table).to(device)
        UPLOADS.add(f"{name}/table")
    elif table.device != device or table.dtype != torch.int64 or tuple(table.shape) != group.table.shape:
        raise ValueError(f"the table must be the group's int64 {group.table.shape} on {device}")
    launch(name, f"hegp_{name}_group", device, *(b.data_ptr() for b in buffers), table.data_ptr(),
           len(group.table), group.blocks)


def _check_packed(name: str, group: Group, *buffers: Tuple[torch.Tensor, torch.dtype, int]) -> torch.device:
    """Every packed buffer 1-D, contiguous, of its dtype and length, on one CPU or CUDA device."""
    devices = {t.device for t, _, _ in buffers}
    device = next(iter(devices))
    if len(devices) != 1 or device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} needs its buffers on one CPU or CUDA device, got {sorted(map(str, devices))}")
    for t, dtype, length in buffers:
        if t.dtype != dtype or t.dim() != 1 or t.numel() != length or not t.is_contiguous():
            raise ValueError(f"{name} needs a contiguous 1-D {dtype} buffer of {length}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    return device


# ---------------------------------------------------------------------------
# dequantize
# ---------------------------------------------------------------------------


def dequantize_reference(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(R, C) int8 x (C,) or (1, C) float32 -> (R, C) float32, plain PyTorch."""
    return values.to(torch.float32) * scales.reshape(1, -1)


def dequantize_group_reference(packed_values: torch.Tensor, packed_scales: torch.Tensor,
                               table) -> torch.Tensor:
    """The plain version of a group: walks ``table`` (the group's numpy table),
    slicing the packed buffers, through ``dequantize_reference`` leaf by leaf.  Returns
    the packed float32 output, as long as ``packed_values``, each leaf at its
    output offset (what lies between leaves is undefined)."""
    out = torch.empty(packed_values.numel(), dtype=torch.float32, device=packed_values.device)
    for voff, soff, ooff, rows, cols, _ in np.asarray(table).tolist():
        n = rows * cols
        out[ooff:ooff + n] = dequantize_reference(packed_values[voff:voff + n].view(rows, cols),
                                                  packed_scales[soff:soff + cols]).reshape(-1)
    return out


def dequantize_packed(values: torch.Tensor, scales: torch.Tensor, group: Group,
                      table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A packed group -> its packed float32 output (``group.values`` long).

    ``values`` (int8, ``group.values`` long) and ``scales`` (float32,
    ``group.scales`` long) lie as ``group`` says, on one device.  On CUDA one
    launch of ``csrc/dequantize.cu`` (``table``: ``group.table`` already on
    the card, or None to upload it); on the CPU the plain version.
    """
    device = _check_packed("dequantize", group, (values, torch.int8, group.values),
                           (scales, torch.float32, group.scales))
    if device.type == "cpu":
        return dequantize_group_reference(values, scales, group.table)
    out = torch.empty(group.values, dtype=torch.float32, device=device)
    if group.blocks:
        _launch("dequantize", group, table, values, scales, out)
    return out


def _host_leaf(a, what: str) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"dequantize_group packs host arrays, got {what} on {a.device} "
                             f"(a leaf already on the card goes through dequantize)")
        return a.detach().numpy()
    return np.asarray(a)


def pack_dequantize_group(leaves: Sequence[Tuple[Any, Any]]) -> Tuple[np.ndarray, np.ndarray, Group]:
    """(values (R, C) int8, scales (C,) or (1, C) float32) pairs of host arrays
    (numpy or CPU tensors) -> (packed int8 values, packed float32 scales,
    group), on the host, as ``dequantize_layout`` lays them out."""
    if not leaves:
        raise ValueError("dequantize_group needs at least one leaf")
    pairs = [(_host_leaf(v, "values"), _host_leaf(s, "scales")) for v, s in leaves]
    for v, s in pairs:
        if v.dtype != np.int8 or v.ndim != 2:
            raise ValueError(f"values must be 2-D int8, got {v.dtype} {v.shape}")
        if s.dtype != np.float32 or s.size != v.shape[1] or s.ndim not in (1, 2):
            raise ValueError(f"scales must be float32 of shape ({v.shape[1]},) or (1, {v.shape[1]}), "
                             f"got {s.dtype} {s.shape}")
    group = dequantize_layout([v.shape for v, _ in pairs])
    t = group.table
    gaps = np.append(t[1:, 0], group.values) - t[:, 0] - t[:, 3] * t[:, 4]  # padding after each leaf
    pieces = []
    for (v, _), gap in zip(pairs, gaps.tolist()):
        pieces.append(v.reshape(-1))
        if gap:
            pieces.append(np.zeros(gap, np.int8))
    values = np.concatenate(pieces)
    scales = np.concatenate([s.reshape(-1) for _, s in pairs])
    return values, scales, group


def dequantize_group(leaves: Sequence[Tuple[Any, Any]], device) -> List[torch.Tensor]:
    """Dequantize a group of int8 leaves onto ``device`` with one launch.

    ``leaves``: (values (R, C) int8, scales (C,) or (1, C) float32) pairs of
    host arrays (numpy or CPU tensors), as a checkpoint stores them.  They
    are packed on the host (``pack_dequantize_group``), uploaded (the
    values, the scales and the table: one copy each) and dequantized by
    ``dequantize_packed``.  Returns each leaf's (R, C) float32 result, in
    order: views of one buffer on ``device``.  The uploads are counted in
    ``utils/device.py::UPLOADS`` (the table's in ``_launch``, on the card).
    """
    values, scales, group = pack_dequantize_group(leaves)
    device = torch.device(device)
    values, scales = torch.from_numpy(values).to(device), torch.from_numpy(scales).to(device)
    UPLOADS.add("dequantize_group/values")
    UPLOADS.add("dequantize_group/scales")
    out = dequantize_packed(values, scales, group)
    t = group.table
    return [p.view(r, c) for p, (r, c) in zip(_split(out, t[:, 2], t[:, 3] * t[:, 4]), t[:, 3:5].tolist())]


def dequantize(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(R, C) int8 x (C,) or (1, C) float32 scales -> (R, C) float32, on their device.

    A group of one: on CUDA one launch of ``csrc/dequantize.cu`` on the
    tensors as they are, or an error; on the CPU the plain version.
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
    group = dequantize_layout([(rows, cols)])
    return dequantize_packed(values.view(-1), scales.view(-1), group).view(rows, cols)


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------


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


def quantize_group_reference(packed_x: torch.Tensor, table) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of a group: walks ``table`` (the group's numpy table)
    over ``quantize_reference`` leaf by leaf.  Returns the packed int8 values (as
    long as ``packed_x``, each leaf at its output offset) and the packed
    float32 scales."""
    rows = np.asarray(table).tolist()
    values = torch.empty(packed_x.numel(), dtype=torch.int8, device=packed_x.device)
    scales = torch.empty(sum(c for _, _, _, _, c, _ in rows), dtype=torch.float32, device=packed_x.device)
    for xoff, soff, voff, r, c, _ in rows:
        q, s = quantize_reference(packed_x[xoff:xoff + r * c].view(r, c))
        values[voff:voff + r * c] = q.reshape(-1)
        scales[soff:soff + c] = s.reshape(-1)
    return values, scales


def quantize_packed(x: torch.Tensor, group: Group,
                    table: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A packed float32 group -> (packed int8 values, ``group.values`` long;
    packed float32 scales, ``group.scales`` long), on ``x``'s device.

    On CUDA one launch of ``csrc/quantize.cu`` (``table``: ``group.table``
    already on the card, or None to upload it); on the CPU the plain version.
    The kernel is bit-equal to the plain version on finite input.  A column
    holding NaN gets a NaN scale on both paths (as in numpy); its int8
    values are those of a NaN-to-int8 cast, which numpy and torch leave
    unspecified (0 on the card's kernel).
    """
    device = _check_packed("quantize", group, (x, torch.float32, group.values))
    if device.type == "cpu":
        return quantize_group_reference(x, group.table)
    values = torch.empty(group.values, dtype=torch.int8, device=device)
    scales = torch.empty(group.scales, dtype=torch.float32, device=device)
    _launch("quantize", group, table, x, values, scales)
    return values, scales


def pack_quantize_group(xs: Sequence[Any], device=None) -> Tuple[torch.Tensor, Group]:
    """(R, C) float32 leaves (numpy arrays or tensors, all on one device) ->
    (one packed buffer on ``device``, the group).  The leaves are packed by
    one ``torch.cat`` where they lie; host leaves are then uploaded in one
    copy.  ``device`` None: where the leaves lie."""
    if not xs:
        raise ValueError("quantize_group needs at least one leaf")
    ts = [x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x)) for x in xs]
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"quantize_group needs every leaf on one device, got {sorted(map(str, devices))}")
    src = devices.pop()
    device = src if device is None else torch.device(device)
    if src.type != "cpu" and src.type != device.type:
        raise ValueError(f"quantize_group got leaves on {src} for {device}")
    for t in ts:
        if t.dtype != torch.float32 or t.dim() != 2 or 0 in t.shape:
            raise ValueError(f"quantize_group needs non-empty 2-D float32 leaves, got {t.dtype} {tuple(t.shape)}")
    group = quantize_layout([tuple(t.shape) for t in ts])
    return torch.cat([t.reshape(-1) for t in ts]).to(device), group


def quantize_group(xs: Sequence[Any], device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(R, C) float32 leaves -> [((R, C) int8 values, (1, C) float32 scales)], with one launch.

    ``pack_quantize_group`` packs the leaves onto ``device`` (None: where
    they lie), ``quantize_packed`` quantizes the group; each result is a view
    of the packed outputs.
    """
    packed, group = pack_quantize_group(xs, device)
    values, scales = quantize_packed(packed, group)
    t = group.table
    return [(q.view(r, c), s.view(1, c)) for q, s, (r, c) in zip(
        _split(values, t[:, 2], t[:, 3] * t[:, 4]), _split(scales, t[:, 1], t[:, 4]), t[:, 3:5].tolist())]


def quantize(x2d: torch.Tensor):
    """(R, C) float32 -> ((R, C) int8 values, (1, C) float32 scales), on its device.

    A group of one: on CUDA one launch of ``csrc/quantize.cu`` on the tensor
    as it is, or an error; on the CPU the plain version (``quantize_packed``
    says what a NaN column gives).
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
    values, scales = quantize_packed(x2d.view(-1), quantize_layout([(rows, cols)]))
    return values.view(rows, cols), scales.view(1, cols)


def host_array(leaf) -> np.ndarray:
    """A leaf as the JAX package's ``np.asarray`` gives it: a tensor as a C-ordered
    array, a numpy array as it is (0-d stays 0-d, Fortran order stays)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous().numpy()
    return np.asarray(leaf)


def _quantized(leaf) -> bool:
    """The JAX package's leaf rule: at least 1024 values and float32."""
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() >= _MIN_QUANT_SIZE and leaf.dtype == torch.float32
    a = np.asarray(leaf)
    return a.size >= _MIN_QUANT_SIZE and a.dtype == np.float32


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def quantize_tree(params, device: torch.device) -> Any:
    """A params tree (nested dicts and lists of tensors or arrays) with every
    leaf packed by the JAX package's leaf rule: fewer than 1024 values, or
    not float32 -> ``{"fp32": a}``; otherwise ``{"int8", "scales", "shape"}``
    over ``reshape(-1, a.shape[-1])``.

    The large leaves, in tree order, are quantized on ``device`` as one
    group (``pack_quantize_group``, ``quantize_packed``: host leaves uploaded
    in one copy, one launch), and the packed values and scales come back in
    one copy each.  Host numpy arrays come back, with the dtypes and shapes
    the JAX package writes: ``scales`` is (C,), and ``shape`` is the tuple of
    ints, which a checkpoint stores as the 0-d int64 members ``shape/0``,
    ``shape/1``, ...
    """
    big: List[Any] = []
    _map_leaves(lambda leaf: big.append(leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
                if _quantized(leaf) else None, params)
    packed: List[Dict[str, Any]] = []
    if big:
        x, group = pack_quantize_group([leaf.reshape(-1, leaf.shape[-1]) for leaf in big], device)
        values, scales = (t.cpu().numpy() for t in quantize_packed(x, group))
        for leaf, (_, soff, voff, r, c, _) in zip(big, group.table.tolist()):
            shape = tuple(leaf.shape)
            packed.append({"int8": values[voff:voff + r * c].reshape(shape), "scales": scales[soff:soff + c],
                           "shape": shape})
    results = iter(packed)
    return _map_leaves(lambda leaf: next(results) if _quantized(leaf) else {"fp32": host_array(leaf)}, params)


def quantized_nbytes(tree) -> int:
    """Bytes of every array of a (packed) tree, as ``np.asarray(leaf).nbytes``."""
    if isinstance(tree, dict):
        return sum(quantized_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(quantized_nbytes(v) for v in tree)
    return host_array(tree).nbytes
