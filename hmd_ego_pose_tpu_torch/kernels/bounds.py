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
    """float32 in, int8 and float32 scales out; abs, max, divide, round, clip per value."""
    return values * (4 + 1) + scales * 4, values * 5


def min_distances_work(t: int, p: int, q: int) -> Tuple[float, float]:
    """(T, P, 3) and (T, Q, 3) float32 in, (T, P) out; 3 sub, 3 mul, 2 add, 1 min per pair."""
    return t * (p + q) * 3 * 4 + t * p * 4, t * p * q * 9


def iou_work(n: int, k: int, batch: int) -> Tuple[float, float]:
    """Per image: (N, 4) anchors x (K, 4) boxes float32 in, (N, K) out; ~17 ops per pair."""
    return batch * (n * 4 * 4 + k * 4 * 4 + n * k * 4), batch * n * k * 17
