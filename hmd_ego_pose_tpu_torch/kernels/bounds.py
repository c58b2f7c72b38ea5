"""The least time an H100 could take for each kernel's work: one place for the rates and formulas.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate, and
its operations over the float32 rate outside the tensor cores.  Each
``*_work`` function gives (bytes, operations) for the shapes it is called
with; ``chip_smoke.py`` calls them with the inputs of its run and
``scripts/kernel_bounds.py`` with the shapes of every path.
"""

from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
F32_OPS_PER_S = 67e12  # H100 SXM published float32 rate outside the tensor cores


def bound(moved: float, ops: float) -> Dict[str, object]:
    """{"bytes", "operations", "bound_ms", "bound_by"} of work that moves
    ``moved`` bytes and does ``ops`` float32 operations."""
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"bytes": moved, "operations": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def dequantize_work(values: int, scales: int) -> Tuple[float, float]:
    """int8 in, float32 out, a row of float32 scales; one multiply per value."""
    return values * (1 + 4) + scales * 4, values


def quantize_work(values: int, scales: int) -> Tuple[float, float]:
    """float32 in, int8 and float32 scales out; abs, max, divide, round, clip per value.

    The least the work needs: x read once.  ``csrc/quantize.cu`` reads x twice
    (column maxima, then the quotients), 9 bytes per value instead of 5."""
    return values * (4 + 1) + scales * 4, values * 5


def min_distances_work(t: int, p: int, q: int) -> Tuple[float, float]:
    """(T, P, 3) and (T, Q, 3) float32 in, (T, P) out; 3 sub, 3 mul, 2 add, 1 min per pair.

    The bound is against the published 67 TFLOP/s, which counts an FMA as two
    operations.  The bit-equal arithmetic of ``csrc/min_distances.cu`` has no
    FMA: its 9 instructions a pair run at 128 lanes per clock per SM, so its
    ceiling is about twice this bound (~19-22 us at the evaluation's shape,
    132 SMs at 1.75-1.98 GHz)."""
    return t * (p + q) * 3 * 4 + t * p * 4, t * p * q * 9


def iou_work(n: int, k: int, batch: int, shared_anchors: bool = False) -> Tuple[float, float]:
    """(B, N, 4) anchors (or one (N, 4) set the batch shares) x (B, K, 4) boxes
    float32 in, (B, N, K) out; ~17 operations per pair."""
    anchor_sets = 1 if shared_anchors else batch
    return anchor_sets * n * 4 * 4 + batch * (k * 4 * 4 + n * k * 4), batch * n * k * 17


def target_assign_work(n: int, k: int, batch: int, num_classes: int, dt: int = 8,
                       dc: int = 63) -> Tuple[float, float]:
    """(N, 4) anchors shared by the batch and (B, K) padded ground truth in
    (boxes 4, label int32, transformation DT, coords DC, valid one byte), the five
    per-anchor targets out: (B, N, C + 4 + DT + DC + 1) float32.  ~17 operations
    per anchor-row IoU and ~20 per anchor for the thresholds and ``bbox_transform``."""
    gt_bytes = batch * k * ((4 + 1 + dt + dc) * 4 + 1)
    out_bytes = batch * n * (num_classes + 4 + dt + dc + 1) * 4
    return n * 4 * 4 + gt_bytes + out_bytes, batch * n * (k * 17 + 20)
