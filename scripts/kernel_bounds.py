"""The least time an H100 could take for each TPU kernel's work, from its shapes.

    python scripts/kernel_bounds.py

For every function of the JAX package that reaches ``pl.pallas_call``, the
bytes it must move (each input read once, each output written once) over
the card's memory rate, and its operations over the float32 rate outside the
tensor cores; the bound is the larger of the two.  Shapes are the ones its
path gives it: the shipped handrel artifact's int8 leaves (dequantize,
quantize), the 200-frame evaluation (min distances: T=200 pose pairs of
P=Q=600 model points), and a training batch of 16 images at 256 px with one
ground-truth box each (IoU).  Prints one JSON line per kernel.  Runs on the
CPU.  The rates and formulas are ``hmd_ego_pose_tpu_torch/kernels/bounds.py``,
which ``chip_smoke.py`` also uses for the ported kernels on its run's inputs.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from hmd_ego_pose_tpu_torch.config import ModelConfig  # noqa: E402
from hmd_ego_pose_tpu_torch.kernels import bounds  # noqa: E402

ARTIFACT = os.path.join(REPO, "trained", "syn1000_phi0_576ep_handrel_int8.npz")


def row(name: str, replaces: str, work, shapes: str) -> dict:
    return {"kernel": name, "replaces": replaces, "shapes": shapes, **bounds.bound(*work)}


def main() -> None:
    with np.load(ARTIFACT) as data:
        leaves = [(data[k].size, data[k].shape[-1]) for k in data.files if k.endswith("/int8")]
    values = sum(n for n, _ in leaves)
    cols = sum(c for _, c in leaves)
    artifact = f"{len(leaves)} leaves, {values} values"
    t, p, q = 200, 600, 600  # the 200-frame evaluation, the 600-point synthetic cuboid
    n, k, batch = ModelConfig(image_size=256).total_anchors, 1, 16
    rows = [
        row("dequantize", "hmd_ego_pose_tpu/ops/quantization.py:64", bounds.dequantize_work(values, cols), artifact),
        row("quantize", "hmd_ego_pose_tpu/ops/quantization.py:39", bounds.quantize_work(values, cols), artifact),
        row("min_distances", "hmd_ego_pose_tpu/ops/pallas_kernels.py:126", bounds.min_distances_work(t, p, q),
            f"T={t}, P={p}, Q={q}"),
        row("iou_matrix", "hmd_ego_pose_tpu/ops/pallas_kernels.py:69", bounds.iou_work(n, k, batch),
            f"batch {batch}, N={n}, K={k}"),
    ]
    for r in rows:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
