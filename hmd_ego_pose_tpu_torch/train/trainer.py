"""The training loop: epochs over the resident split, validation, checkpoints, LR.

Counterpart of ``hmd_ego_pose_tpu/train/trainer.py`` on its device-resident
path: oversampled epochs of the numpy sampler's indices, validation every
``eval_every`` epochs through the evaluator (ADD-S on the min-distance
kernel), ReduceLROnPlateau on the mixed point-distance mean, a
metric-named best checkpoint and a rolling ``last`` checkpoint that carries
the optimizer state, both in the JAX package's layout.

Randomness comes from one host ``torch.Generator`` seeded from
``TrainConfig.seed``: every augmentation draw and every drop-connect mask.
The epoch indices come from ``np.random.RandomState(seed)`` as in the JAX
package, so the port visits the frames in the same order.

Not ported, and refused here: the host input pipeline
(``device_augment=False`` or ``device_resident=False``), the windowed
residency of splits larger than ``device_resident_budget_bytes``, more
than one object per frame, ``remat_backbone``, and meshes.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from hmd_ego_pose_tpu_torch.config import Config
from hmd_ego_pose_tpu_torch.data.device_dataset import build_host_cache, upload_window
from hmd_ego_pose_tpu_torch.data.pipeline import InputPipeline
from hmd_ego_pose_tpu_torch.eval.evaluator import EvalResult, evaluate_model
from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose, init_weights
from hmd_ego_pose_tpu_torch.models.weights import from_jax_params, to_jax_params
from hmd_ego_pose_tpu_torch.ops.augment_device import draw_augment
from hmd_ego_pose_tpu_torch.train.checkpoint import checkpoint_name, save_checkpoint
from hmd_ego_pose_tpu_torch.train.plateau import ReduceLROnPlateau
from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES, TrainStep, make_eval_forward
from hmd_ego_pose_tpu_torch.utils.device import DeviceLike, resolve_device
from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger


def check_supported(config: Config) -> None:
    """Raise on the training features the port does not have."""
    if not (config.data.device_resident and config.data.device_augment):
        raise NotImplementedError(
            "the PyTorch port trains only with the split resident on the device and augmented "
            "there (device_resident and device_augment); the host input pipeline is not ported")
    if config.data.max_objects != 1 or config.model.num_classes != 1:
        raise NotImplementedError("multi-object training (--object-ids) is not ported to the PyTorch package")
    if config.model.remat_backbone:
        raise NotImplementedError("remat_backbone is not ported to the PyTorch package")


class Trainer:
    def __init__(self, config: Config, train_dataset, val_dataset, device: DeviceLike = None,
                 logger: Optional[MetricLogger] = None, params=None, bn_state=None,
                 opt_leaves=None, start_step: int = 0):
        check_supported(config)
        self.config = config
        self.device = dev = resolve_device(device)
        self.train_dataset, self.val_dataset = train_dataset, val_dataset
        self.logger = logger or MetricLogger()

        self.model = HMDEgoPose(config.model).to(dev)
        if params is None:
            init_weights(self.model, torch.Generator().manual_seed(config.train.seed))
        else:
            self.model.load_state_dict(from_jax_params(params, bn_state, config.model), strict=True)

        self.pipeline = InputPipeline(train_dataset, config.data, config.train.batch_size,
                                      seed=config.train.seed)
        cache = build_host_cache(train_dataset, config.data.max_objects)
        size = sum(a.nbytes for a in cache)
        if size > config.data.device_resident_budget_bytes:
            raise NotImplementedError(
                f"the decoded split ({size} bytes) exceeds device_resident_budget_bytes; the "
                "windowed residency of the JAX package is not ported")
        self.frame_hw = cache.frames.shape[1:3]
        self.data = upload_window(cache, dev)

        model_points = train_dataset.model_points_for_loss(config.train.loss.num_model_points)
        self.step_fn = TrainStep(self.model, config, model_points, dev,
                                 symmetric=bool(cache.gt_is_sym.any()))
        self.optimizer = self.step_fn.optimizer
        if opt_leaves is not None:
            self.optimizer.load_leaves(opt_leaves)
            self.optimizer.set_learning_rate(config.train.learning_rate)
        self._steps_done = int(start_step)
        self.generator = torch.Generator().manual_seed(config.train.seed)
        self.scheduler = ReduceLROnPlateau(
            config.train.learning_rate, factor=config.train.plateau_factor,
            patience=config.train.plateau_patience, threshold=config.train.plateau_threshold,
            min_lr=config.train.min_learning_rate,
        )
        self.best_metric = float("inf")
        self.best_checkpoint: Optional[str] = None

    def draws(self):
        """One batch's augmentation draws (None when both augmentations are off)."""
        dc = self.config.data
        if not (dc.use_colorspace_augmentation or dc.use_6dof_augmentation):
            return None
        h, w = self.frame_hw
        return draw_augment(self.generator, self.config.train.batch_size, h, w,
                            dc.chance_no_augmentation, dc.scale_6dof_augmentation)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch of steps; returns the metric means, ``steps`` and ``epoch_seconds``."""
        t0 = time.perf_counter()
        idxs = self.pipeline.epoch_indices(self.config.train.oversample)
        if idxs.shape[0] == 0:
            raise ValueError(
                f"zero steps/epoch: batch_size {self.config.train.batch_size} exceeds the "
                f"{len(self.train_dataset)}-frame dataset (x oversample {self.config.train.oversample})")
        sums = None
        for row in idxs:
            idx = torch.from_numpy(row.astype("int64")).to(self.device)
            metrics = self.step_fn(self.data, idx, self.draws(), self.generator)
            values = torch.stack([metrics[k] for k in METRIC_NAMES])
            sums = values if sums is None else sums + values
        means = dict(zip(METRIC_NAMES, (sums / idxs.shape[0]).tolist()))  # the epoch's one read
        self._steps_done += idxs.shape[0]
        means["steps"] = idxs.shape[0]
        means["epoch_seconds"] = time.perf_counter() - t0
        return means

    def validate(self, max_images: Optional[int] = None) -> EvalResult:
        self.model.eval()
        return evaluate_model(self.val_dataset, make_eval_forward(self.model, self.config, self.device),
                              self.config, self.device, max_eval_images=max_images)

    def jax_trees(self):
        """(params, bn_state) in the JAX package's layout, host numpy."""
        return to_jax_params(self.model.state_dict(), self.config.model)

    def fit(self, epochs: Optional[int] = None, max_eval_images: Optional[int] = None,
            on_epoch_end: Optional[Callable] = None) -> Optional[str]:
        epochs = epochs if epochs is not None else self.config.train.epochs
        eval_every = max(1, self.config.train.eval_every)
        pending = []
        new_lr = self.scheduler.lr
        for epoch in range(epochs):
            pending.append((epoch, self.train_epoch(epoch)))
            if (epoch + 1) % eval_every != 0 and epoch != epochs - 1:
                continue
            for ep, m in pending:
                self.logger.log_scalars(ep, {"lr": new_lr, **m})
            train_metrics = pending[-1][1]
            n_since_eval = len(pending)
            pending = []

            result = self.validate(max_images=max_eval_images)
            metric = result.mixed_point_distance_mean_mm
            new_lr = self.scheduler.step(metric, n_epochs=max(1, n_since_eval))
            self.optimizer.set_learning_rate(new_lr)
            self.logger.log_scalars(epoch, {f"val/{k}": v for k, v in result.scalars().items()})

            tc, cfg = self.config.train, self.config
            params, bn_state = self.jax_trees()
            if metric < self.best_metric:
                self.best_metric = metric
                name = checkpoint_name(cfg.data.dataset, cfg.data.fold, cfg.model.iter_steps, metric, epoch)
                self.best_checkpoint = save_checkpoint(
                    tc.checkpoint_dir, name, params, bn_state,
                    metadata={"epoch": epoch, "metric": metric, "hand_relative": cfg.model.hand_relative,
                              "config": repr(cfg), "metrics": result.scalars()},
                )
            save_checkpoint(
                tc.checkpoint_dir, "last", params, bn_state,
                metadata={"epoch": epoch, "metric": metric, "train_step": self._steps_done,
                          "hand_relative": cfg.model.hand_relative, "config": repr(cfg)},
                opt_leaves=self.optimizer.leaves(),
            )
            if on_epoch_end is not None:
                on_epoch_end(epoch, train_metrics, result)
        return self.best_checkpoint
