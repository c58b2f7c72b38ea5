"""Model export via ``torch.export``: the counterpart of ``hmd_ego_pose_tpu/export/stablehlo.py``.

``export_inference`` builds the network from JAX-layout trees, folds its
batch norms (``models/folding.py``), exports the raw forward (NHWC float32
images -> the dict of the five head outputs, keys sorted) with
``torch.export.export`` and saves it to ``<name>.pt2``, beside the seeded
input ``<name>_input.npy`` (byte-equal to the JAX package's), the eager
model's outputs on that input ``<name>_golden.npz`` and ``<name>_meta.json``
(the JAX package's keys and values).  ``load_and_verify`` loads the program
back with ``torch.export.load``, runs it on the device and holds its outputs
to the goldens with the JAX package's tolerances.  ONNX is not written.

The program is traced on the device it is exported on, and its weights are
saved there: verify it on the same kind of device.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from hmd_ego_pose_tpu_torch.config import ModelConfig
from hmd_ego_pose_tpu_torch.models.folding import fold_batch_norms
from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
from hmd_ego_pose_tpu_torch.models.weights import from_jax_params
from hmd_ego_pose_tpu_torch.utils.device import DeviceLike, resolve_device

OUTPUTS = ("classification", "hand", "regression", "rotation", "translation_raw")  # sorted


class RawForward(nn.Module):
    """NHWC float32 images -> {classification, hand, regression, rotation,
    translation_raw}, float32: the raw head outputs without the feature maps."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.model(images.permute(0, 3, 1, 2).to(self.model.dtype))
        return {k: getattr(out, k) for k in OUTPUTS}


def export_inference(params, bn_state, config: ModelConfig, out_dir: str, name: str = "hmd_ego_pose",
                     batch_size: int = 1, rng_seed: int = 0, fold_bn: bool = True,
                     device: DeviceLike = None) -> str:
    """Write the ``torch.export`` program of the raw forward and its goldens; returns ``out_dir``.

    ``params`` / ``bn_state``: JAX-layout trees (numpy arrays or tensors).
    """
    dev = resolve_device(device)
    model = HMDEgoPose(config).to(dev).eval()
    model.load_state_dict(from_jax_params(params, bn_state, config), strict=True)
    if fold_bn:
        model = fold_batch_norms(model)
    forward = RawForward(model).eval()
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(rng_seed)
    sample = rng.uniform(-1, 1, size=(batch_size, config.image_size, config.image_size, 3)).astype(np.float32)
    x = torch.from_numpy(sample).to(dev)
    program = torch.export.export(forward, (x,))
    torch.export.save(program, os.path.join(out_dir, f"{name}.pt2"))

    np.save(os.path.join(out_dir, f"{name}_input.npy"), sample)
    with torch.inference_mode():
        golden = {k: v.cpu().numpy() for k, v in forward(x).items()}
    np.savez(os.path.join(out_dir, f"{name}_golden.npz"), **golden)
    with open(os.path.join(out_dir, f"{name}_meta.json"), "w") as f:
        json.dump(
            {
                "image_size": config.image_size,
                "phi": config.phi,
                "batch_size": batch_size,
                "outputs": sorted(golden.keys()),
            },
            f,
            indent=2,
        )
    return out_dir


def load_and_verify(out_dir: str, name: str = "hmd_ego_pose", atol: float = 1e-5,
                    device: DeviceLike = None) -> bool:
    """Load ``<name>.pt2``, run it on ``device`` and check its outputs against the goldens
    (``atol``, rtol 1e-4); raises on a mismatch."""
    dev = resolve_device(device)
    program = torch.export.load(os.path.join(out_dir, f"{name}.pt2"))
    sample = np.load(os.path.join(out_dir, f"{name}_input.npy"))
    with np.load(os.path.join(out_dir, f"{name}_golden.npz")) as data:
        golden = {k: data[k] for k in data.files}
    with torch.inference_mode():
        outputs = program.module()(torch.from_numpy(sample).to(dev))
    for key, want in golden.items():
        np.testing.assert_allclose(outputs[key].cpu().numpy(), want, atol=atol, rtol=1e-4)
    return True
