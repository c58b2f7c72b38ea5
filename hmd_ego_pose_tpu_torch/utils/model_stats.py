"""Model size, parameter and FLOP report printed when training starts.

Counterpart of ``hmd_ego_pose_tpu/utils/model_stats.py``.  Parameters are
counted from the module; FLOPs of one forward come from
``torch.utils.flop_counter.FlopCounterMode`` (2 per multiply-add of every
convolution and matrix product), where the JAX package reads XLA's cost
analysis.
"""

from __future__ import annotations

import torch


def count_params(model: torch.nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))


def param_bytes(model: torch.nn.Module) -> int:
    return int(sum(p.numel() * p.element_size() for p in model.parameters()))


def forward_flops(model: torch.nn.Module, image_size: int, batch_size: int = 1) -> float:
    """FLOPs of one eval forward of ``batch_size`` frames at ``image_size``."""
    from torch.utils.flop_counter import FlopCounterMode

    p = next(model.parameters())
    x = torch.zeros((batch_size, 3, image_size, image_size), dtype=p.dtype, device=p.device)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(x)
    finally:
        model.train(was_training)
    return float(counter.get_total_flops())


def format_model_stats(model: torch.nn.Module, image_size: int, batch_size: int = 1) -> str:
    """The 'HMD-EgoPose parameter count / size / flops' block."""
    n = count_params(model)
    lines = [
        f"HMD-EgoPose parameter count: {n}",
        f"Size (MB): {param_bytes(model) / (1024.0 * 1024.0):.3f}",
        f"Model params: {n / 1e6:.2f} M",
        f"Model flops:  {forward_flops(model, image_size, batch_size) / 1e9:.2f} GFLOPs "
        f"(batch {batch_size} @ {image_size}px, torch FlopCounterMode)",
    ]
    return "\n".join(lines)
