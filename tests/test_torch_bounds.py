"""Kernel bounds (``hmd_ego_pose_tpu_torch/kernels/bounds.py``) at the shapes of the port's paths.

The figures are the ones worked out by hand from the shapes: min distances
at the 200-frame evaluation is bound by its 6.5e8 float32 operations
(~9.7 us), the dequantize and quantize of the shipped artifact's 137 int8
leaves by their 19.4 MB (~5.8 us), the IoU of a 16-image training batch
at 256 px by its 3.9 MB (~1.2 us), and the fused target assignment of the
same batch (one box, one class) by its 60.7 MB, nearly all the five outputs
written (~18.1 us).
"""

import json
import os
import subprocess
import sys

import pytest

from hmd_ego_pose_tpu_torch.kernels import bounds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("work,bound_ms,bound_by", [
    (bounds.min_distances_work(200, 600, 600), 0.00967, "operations"),
    (bounds.dequantize_work(3_841_920, 55_020), 0.00580, "bytes"),
    (bounds.quantize_work(3_841_920, 55_020), 0.00580, "bytes"),
    (bounds.iou_work(12_276, 1, 16), 0.001173, "bytes"),
    (bounds.iou_work(12_276, 1, 16, shared_anchors=True), 0.000293, "bytes"),  # the train step's layout
    (bounds.target_assign_work(12_276, 1, 16, 1), 0.018119, "bytes"),
])
def test_bound_at_the_paths_shapes(work, bound_ms, bound_by):
    got = bounds.bound(*work)
    assert got["bound_ms"] == pytest.approx(bound_ms, rel=2e-3)
    assert got["bound_by"] == bound_by


def test_kernel_bounds_script_lists_all_four_tpu_kernels():
    """The four TPU kernels, and the fused target assignment that replaces the
    IoU kernel on the train path."""
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "kernel_bounds.py")],
                         capture_output=True, text=True, check=True, timeout=120).stdout
    rows = {r["kernel"]: r for r in map(json.loads, out.splitlines())}
    assert sorted(rows) == ["dequantize", "iou_matrix", "min_distances", "quantize", "target_assign"]
    assert rows["dequantize"]["bytes"] == 19_429_680
    assert rows["min_distances"]["operations"] == 648_000_000
    assert rows["target_assign"]["bytes"] == 60_697_424
    for r in rows.values():
        assert r["bound_ms"] > 0 and r["replaces"].startswith("hmd_ego_pose_tpu/")
