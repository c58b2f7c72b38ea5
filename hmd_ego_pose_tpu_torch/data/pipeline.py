"""The training sampler: epoch indices from the JAX package's numpy stream.

Counterpart of the device-resident half of ``hmd_ego_pose_tpu/data/pipeline.py``:
``InputPipeline.rng`` is ``np.random.RandomState(seed)`` and
``epoch_indices`` concatenates ``oversample`` permutations and cuts them into
whole batches, so for the same seed the port's epochs visit the frames in
the same order as the JAX package's.  The host pipeline (``batches``, with
host-side augmentation in worker threads) is not ported: the trainer
refuses the configs that would need it.
"""

from __future__ import annotations

import numpy as np

from hmd_ego_pose_tpu_torch.config import DataConfig


class InputPipeline:
    """Epoch indices over ``dataset`` (preloaded when the config says so)."""

    def __init__(self, dataset, data_config: DataConfig, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.cfg = data_config
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        if data_config.preload and hasattr(dataset, "preload"):
            dataset.preload(data_config.preload_budget_bytes)

    def epoch_indices(self, oversample: int = 1) -> np.ndarray:
        """(steps, batch_size) frame indices of one epoch."""
        n = len(self.dataset)
        idx = np.concatenate([self.rng.permutation(n) for _ in range(oversample)])
        usable = (len(idx) // self.batch_size) * self.batch_size
        return idx[:usable].reshape(-1, self.batch_size)
