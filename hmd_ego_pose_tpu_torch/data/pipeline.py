"""The training sampler and the host input pipeline.

Counterpart of ``hmd_ego_pose_tpu/data/pipeline.py``.  ``InputPipeline.rng``
is ``np.random.RandomState(seed)``; ``epoch_indices`` concatenates
``oversample`` permutations and cuts them into whole batches, so for the same
seed the port's epochs visit the frames in the same order as the JAX
package's.

``batches`` is the host pipeline, for the trainer's paths that do not keep
the split on the device (``device_resident=False``, or a window smaller
than a batch) or augment on the host (``device_augment=False``).  It draws
the epoch's indices and then one seed per example from the same stream, and
builds each batch in a worker thread from its own ``RandomState(seed)``s,
so a batch does not depend on which thread made it:

* ``device_augment``: a ``RawBatch`` of the cached uint8
  frames, masks and raw labels padded to ``max_objects`` rows, augmented on
  the device by the train step;
* otherwise a ``Batch``: colour and 6-DoF augmentation on the host
  (``data/augment.py``; the 6-DoF warp drops the rows of objects that leave
  the frame), ``preprocess_image``, the labels scaled to the image and
  padded.

The batches are numpy arrays in the train step's layouts (``Batch`` and
``RawBatch`` of ``ops/augment_device.py``); the step uploads them.  At most
``prefetch + workers`` batches are in flight, and the pool is shut down,
its queued batches cancelled, whenever the generator ends, is closed or
raises.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Union

import numpy as np

from hmd_ego_pose_tpu_torch.config import DataConfig
from hmd_ego_pose_tpu_torch.data.augment import ColorAugmenter, augment_6dof, random_6dof_params
from hmd_ego_pose_tpu_torch.data.image import preprocess_image
from hmd_ego_pose_tpu_torch.ops.augment_device import Batch, RawBatch

_PI = np.pi


class InputPipeline:
    """Epoch indices and host batches over ``dataset`` (preloaded when the config says so)."""

    def __init__(self, dataset, data_config: DataConfig, batch_size: int, seed: int = 0,
                 image_size: Optional[int] = None):
        """``image_size``: the host preprocess's (the model's; default
        ``data_config.image_size``)."""
        self.dataset = dataset
        self.cfg = data_config
        self.image_size = image_size if image_size is not None else data_config.image_size
        self.batch_size = batch_size
        self.max_objects = data_config.max_objects
        self.rng = np.random.RandomState(seed)
        self.color_aug = ColorAugmenter()
        if data_config.preload and hasattr(dataset, "preload"):
            dataset.preload(data_config.preload_budget_bytes)

    # -- one example, augmented and preprocessed on the host ---------------------
    def _load_example(self, index: int, rng: np.random.RandomState):
        image = self.dataset.load_image(index)
        anno = self.dataset.load_annotations(index)
        cam = self.dataset.load_camera_matrix(index)

        if rng.random_sample() >= self.cfg.chance_no_augmentation:
            if self.cfg.use_colorspace_augmentation:
                image = self.color_aug(image, rng)
            if self.cfg.use_6dof_augmentation:
                mask = self.dataset.load_mask(index)
                angle, scale = random_6dof_params(rng, self.cfg.scale_6dof_augmentation)
                image, anno, _ = augment_6dof(image, mask, anno, cam, angle, scale,
                                              mask_values=anno.get("mask_values"))

        image, image_scale = preprocess_image(image, self.image_size)

        # label space: bboxes and 2-D centres scaled to the image, rotation / pi
        anno["bboxes"] = anno["bboxes"] * image_scale
        anno["rotations"][:, :3] = anno["rotations"][:, :3] / _PI
        anno["translations_x_y_2D"] = anno["translations_x_y_2D"] * image_scale
        coords = anno["coords_3d"] * image_scale

        camera_parameters = np.array(
            [cam[0, 0], cam[1, 1], cam[0, 2], cam[1, 2], self.cfg.translation_scale_norm, image_scale],
            np.float32,
        )

        k = self.max_objects
        num = min(anno["labels"].shape[0], k)
        gt_boxes = np.zeros((k, 4), np.float32)
        gt_labels = np.zeros((k,), np.int32)
        gt_transformation = np.zeros((k, 8), np.float32)
        gt_coords = np.zeros((k, 63), np.float32)
        gt_valid = np.zeros((k,), bool)

        gt_boxes[:num] = anno["bboxes"][:num]
        gt_labels[:num] = anno["labels"][:num]
        # [rot / pi (3), trans mm (3), is_sym, class]
        gt_transformation[:num, :3] = anno["rotations"][:num, :3]
        gt_transformation[:num, 3:6] = anno["translations"][:num]
        gt_transformation[:num, 6:8] = anno["rotations"][:num, 3:5]
        gt_coords[:num] = coords[:num].reshape(num, 63)
        gt_valid[:num] = True

        return image, camera_parameters, gt_boxes, gt_labels, gt_transformation, gt_coords, gt_valid

    def _make_batch(self, indices, seeds) -> Batch:
        parts = [self._load_example(i, np.random.RandomState(s)) for i, s in zip(indices, seeds)]
        return Batch(*[np.stack(x) for x in zip(*parts)])

    # -- one example for the device augmentation -----------------------------------
    def _load_raw_example(self, index: int):
        """The frame, its mask and its raw labels padded to ``max_objects`` rows."""
        image = self.dataset.load_image(index)
        mask = self.dataset.load_mask(index)
        if mask.ndim == 3:
            mask = mask[..., 0]
        anno = self.dataset.load_annotations(index)
        cam = self.dataset.load_camera_matrix(index)

        k = self.max_objects
        num = min(anno["labels"].shape[0], k)
        boxes = np.zeros((k, 4), np.float32)
        rotations = np.zeros((k, 3), np.float32)
        is_sym = np.zeros((k,), np.float32)
        translations = np.zeros((k, 3), np.float32)
        coords = np.zeros((k, 21, 3), np.float32)
        labels = np.zeros((k,), np.int32)
        valid = np.zeros((k,), bool)
        mask_values = np.full((k,), 255, np.int32)

        boxes[:num] = anno["bboxes"][:num]
        rotations[:num] = anno["rotations"][:num, :3]
        is_sym[:num] = anno["rotations"][:num, 3]
        translations[:num] = anno["translations"][:num]
        coords[:num] = anno["coords_3d"][:num]
        labels[:num] = anno["labels"][:num]
        valid[:num] = True
        if "mask_values" in anno:
            mask_values[:num] = anno["mask_values"][:num]
        elif num > 1:
            raise ValueError("multi-object frames need per-object 'mask_values' in annotations "
                             "(which mask pixel value is which object)")

        cam4 = np.array([cam[0, 0], cam[1, 1], cam[0, 2], cam[1, 2]], np.float32)
        return image, mask, cam4, boxes, rotations, is_sym, translations, coords, labels, valid, mask_values

    def _make_raw_batch(self, indices, _seeds) -> RawBatch:
        parts = [self._load_raw_example(i) for i in indices]
        return RawBatch(*[np.stack(x) for x in zip(*parts)])

    # -- iteration -------------------------------------------------------------------
    def epoch_indices(self, oversample: int = 1) -> np.ndarray:
        """(steps, batch_size) frame indices of one epoch."""
        n = len(self.dataset)
        idx = np.concatenate([self.rng.permutation(n) for _ in range(oversample)])
        usable = (len(idx) // self.batch_size) * self.batch_size
        return idx[:usable].reshape(-1, self.batch_size)

    def batches(self, oversample: int = 1, num_workers: Optional[int] = None,
                rows: slice = slice(None)) -> Iterator[Union[Batch, RawBatch]]:
        """The batches of one (oversampled) epoch, made by ``num_workers`` threads
        (``DataConfig.num_workers`` by default; at most one: made in this thread).

        ``rows``: the examples of each batch to make (a data-parallel rank's
        rows); the indices and seeds of the whole batch are drawn all the same,
        so every rank's stream advances as one process's would."""
        groups = self.epoch_indices(oversample)
        seeds = self.rng.randint(0, 2 ** 31 - 1, size=groups.shape)
        groups, seeds = groups[:, rows], seeds[:, rows]
        workers = num_workers if num_workers is not None else self.cfg.num_workers
        make = self._make_raw_batch if self.cfg.device_augment else self._make_batch

        if workers <= 1:
            for g, s in zip(groups, seeds):
                yield make(g, s)
            return

        window = max(1, self.cfg.prefetch) + workers
        pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="input-pipeline")
        pending = collections.deque()
        try:
            jobs = iter(zip(groups, seeds))
            for g, s in jobs:
                pending.append(pool.submit(make, g, s))
                if len(pending) >= window:
                    break
            while pending:
                fut = pending.popleft()
                nxt = next(jobs, None)
                if nxt is not None:
                    pending.append(pool.submit(make, *nxt))
                yield fut.result()
        finally:
            for fut in pending:
                fut.cancel()
            pool.shutdown(wait=True)
