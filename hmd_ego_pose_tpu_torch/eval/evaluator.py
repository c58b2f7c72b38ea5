"""Full-dataset evaluation: detections matched to ground truth, every metric, class means.

Counterpart of ``hmd_ego_pose_tpu/eval/evaluator.py``, with the same
behaviour:

* frames are preprocessed on the host (``data/image.py::preprocess_image``)
  and predicted in fixed batches of ``eval_batch_size``, the tail padded;
* detections are filtered at ``score_threshold`` and capped to
  ``max_detections`` by descending score; rotations are multiplied by pi and
  boxes divided by the image scale;
* detections and annotations are matched within one class label, a
  detection being a true positive if its IoU with an unclaimed annotation is
  at least ``iou_threshold``;
* ADD-S runs once per class over all its true positives
  (``metrics.add_s_batch``: one launch of the min-distance kernel on the card);
* the "mixed" metrics take ADD-S for symmetric objects and ADD otherwise;
* the result is the unweighted mean over the labels that have annotations;
* with ``save_path``, every true positive writes ``det_{i:06d}.png`` (the
  overlay of ``utils/visualization.py::render_frame`` over the raw frame,
  the predicted hand divided by the image scale) and ``samplevis_{i:06d}.png``
  (``utils/samplevis.py``, every tenth model point through both poses).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from hmd_ego_pose_tpu_torch.config import Config
from hmd_ego_pose_tpu_torch.data.image import preprocess_image, write_png
from hmd_ego_pose_tpu_torch.eval import metrics as M
from hmd_ego_pose_tpu_torch.ops.geometry import np_axis_angle_to_matrix
from hmd_ego_pose_tpu_torch.ops.iou import iou_matrix_np
from hmd_ego_pose_tpu_torch.utils.device import DeviceLike, resolve_device
from hmd_ego_pose_tpu_torch.utils.samplevis import draw_samplevis
from hmd_ego_pose_tpu_torch.utils.visualization import render_frame


@dataclasses.dataclass
class EvalResult:
    """Aggregated metrics (all means over the evaluated class set)."""

    mean_ap: float = 0.0
    add_accuracy: float = 0.0
    add_s_accuracy: float = 0.0
    mixed_add_and_add_s_accuracy: float = 0.0
    accuracy_5cm_5degree: float = 0.0
    accuracy_2d_projection: float = 0.0
    translation_error_mean_mm: float = 0.0
    translation_error_std_mm: float = 0.0
    rotation_error_mean_deg: float = 0.0
    rotation_error_std_deg: float = 0.0
    tip_error_mean_mm: float = 0.0
    tip_error_std_mm: float = 0.0
    hand_error_mean_mm: float = 0.0
    hand_error_std_mm: float = 0.0
    point_distance_mean_mm: float = 0.0
    point_distance_std_mm: float = 0.0
    sym_point_distance_mean_mm: float = 0.0
    sym_point_distance_std_mm: float = 0.0
    mixed_point_distance_mean_mm: float = 0.0
    mixed_point_distance_std_mm: float = 0.0
    # matched (true-positive) detections behind the distance means: the
    # standard error of a *_mean_mm is its std / sqrt(num_matched)
    num_matched: int = 0
    # per-class breakdown (label -> EvalResult); not part of scalars()
    per_class: Optional[Dict[int, "EvalResult"]] = None

    def scalars(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d.pop("per_class", None)
        return d


def format_report(result: EvalResult) -> str:
    """The 17-metric report, line for line as the JAX package prints it,
    with the derived Summed_Translation_Rotation_Error."""
    r = result
    summed = (
        r.translation_error_mean_mm + r.translation_error_std_mm
        + r.rotation_error_mean_deg + r.rotation_error_std_deg
    )
    lines = [
        f"mAP: {r.mean_ap:.4f}",
        f"ADD: {r.add_accuracy:.4f}",
        f"ADD-S: {r.add_s_accuracy:.4f}",
        f"5cm_5degree: {r.accuracy_5cm_5degree:.4f}",
        "_________________",
        f"TranslationErrorMean_in_mm: {r.translation_error_mean_mm:.4f}",
        f"TranslationErrorStd_in_mm: {r.translation_error_std_mm:.4f}",
        f"RotationErrorMean_in_degree: {r.rotation_error_mean_deg:.4f}",
        f"RotationErrorStd_in_degree: {r.rotation_error_std_deg:.4f}",
        f"TranslationErrorTipMean_in_mm: {r.tip_error_mean_mm:.4f}",
        f"TranslationErrorTipStd_in_mm: {r.tip_error_std_mm:.4f}",
        f"TranslationErrorHandMean_in_mm: {r.hand_error_mean_mm:.4f}",
        f"TranslationErrorHandStd_in_mm: {r.hand_error_std_mm:.4f}",
        "_________________",
        f"2D-Projection: {r.accuracy_2d_projection:.4f}",
        f"Summed_Translation_Rotation_Error: {summed:.4f}",
        f"ADD(-S): {r.mixed_add_and_add_s_accuracy:.4f}",
        f"AveragePointDistanceMean_in_mm: {r.point_distance_mean_mm:.4f}",
        f"AveragePointDistanceStd_in_mm: {r.point_distance_std_mm:.4f}",
        f"AverageSymmetricPointDistanceMean_in_mm: {r.sym_point_distance_mean_mm:.4f}",
        f"AverageSymmetricPointDistanceStd_in_mm: {r.sym_point_distance_std_mm:.4f}",
        f"MixedAveragePointDistanceMean_in_mm: {r.mixed_point_distance_mean_mm:.4f}",
        f"MixedAveragePointDistanceStd_in_mm: {r.mixed_point_distance_std_mm:.4f}",
    ]
    return "\n".join(lines)


class _ClassAccumulator:
    """Detection and true-positive statistics of ONE class label, over the frames."""

    def __init__(self, model_points, diameter, is_symmetric):
        self.model_points = model_points
        self.diameter = diameter
        self.is_symmetric = is_symmetric
        self.false_positives, self.true_positives, self.scores = [], [], []
        self.num_annotations = 0
        self.tp_add, self.tp_5cm5deg, self.tp_2d = [], [], []
        self.t_diffs, self.r_diffs, self.tip_diffs, self.hand_diffs = [], [], [], []
        self.point_errors = []
        self.tp_poses = []  # (r_gt, t_gt, r_pred, t_pred), for the batched ADD-S

    def finalize(self, ecfg, device: torch.device) -> Tuple[EvalResult, int]:
        """Per-class metrics; ADD-S of all true positives in one batch on ``device``."""
        tp_add_s, sym_point_errors = M.add_s_batch(
            self.model_points, self.diameter, self.tp_poses,
            ecfg.diameter_threshold, ecfg.adds_max_points, device,
        )
        result = EvalResult()
        n = self.num_annotations
        if n == 0:
            return result, 0

        order = np.argsort(-np.asarray(self.scores)) if self.scores else np.array([], int)
        fp = np.cumsum(np.asarray(self.false_positives, float)[order])
        tp = np.cumsum(np.asarray(self.true_positives, float)[order])
        recall = tp / n
        precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        result.mean_ap = M.compute_average_precision(recall, precision) if len(tp) else 0.0

        def acc(flags):
            return float(np.sum(flags)) / n if flags else 0.0

        def mean_std(vals):
            # no true positives: infinitely bad distances, accuracies stay 0
            return (float(np.mean(vals)), float(np.std(vals))) if vals else (float("inf"), float("inf"))

        result.num_matched = len(self.t_diffs)
        result.add_accuracy = acc(self.tp_add)
        result.add_s_accuracy = acc(tp_add_s)
        result.mixed_add_and_add_s_accuracy = (
            result.add_s_accuracy if self.is_symmetric else result.add_accuracy
        )
        result.accuracy_5cm_5degree = acc(self.tp_5cm5deg)
        result.accuracy_2d_projection = acc(self.tp_2d)
        result.translation_error_mean_mm, result.translation_error_std_mm = mean_std(self.t_diffs)
        result.rotation_error_mean_deg, result.rotation_error_std_deg = mean_std(self.r_diffs)
        result.tip_error_mean_mm, result.tip_error_std_mm = mean_std(self.tip_diffs)
        result.hand_error_mean_mm, result.hand_error_std_mm = mean_std(self.hand_diffs)
        result.point_distance_mean_mm, result.point_distance_std_mm = mean_std(self.point_errors)
        result.sym_point_distance_mean_mm, result.sym_point_distance_std_mm = mean_std(sym_point_errors)
        if self.is_symmetric:
            result.mixed_point_distance_mean_mm = result.sym_point_distance_mean_mm
            result.mixed_point_distance_std_mm = result.sym_point_distance_std_mm
        else:
            result.mixed_point_distance_mean_mm = result.point_distance_mean_mm
            result.mixed_point_distance_std_mm = result.point_distance_std_mm
        return result, n


def _aggregate_classes(per_class: Dict[int, Tuple[EvalResult, int]]) -> EvalResult:
    """Unweighted class means, without the labels that have no annotation."""
    present = {c: r for c, (r, n) in per_class.items() if n > 0}
    agg = EvalResult(per_class={c: r for c, (r, _) in per_class.items()})
    if not present:
        return agg
    fields = [f.name for f in dataclasses.fields(EvalResult) if f.name != "per_class"]
    for name in fields:
        vals = [getattr(r, name) for r in present.values()]
        if name == "num_matched":
            agg.num_matched = int(np.sum(vals))  # counts add up, they are not averaged
        else:
            setattr(agg, name, float(np.mean(vals)))
    return agg


def _save_images(save_path: str, i: int, raw: np.ndarray, cam_k: np.ndarray, model_info, model_points,
                 gt: tuple, pred: tuple, boxes: tuple, hands: tuple) -> None:
    """A true positive's ``det_`` overlay and ``samplevis_`` figure, as the JAX
    evaluator writes them.  ``gt`` and ``pred`` are (axis-angle, matrix,
    translation), ``boxes`` and ``hands`` (ground truth, prediction)."""
    overlay = render_frame(raw, cam_k, model_info=model_info, gt_pose=(gt[0], gt[2]), pred_pose=(pred[0], pred[2]),
                           gt_box=boxes[0], pred_box=boxes[1], hand_3d=hands[1])
    write_png(os.path.join(save_path, f"det_{i:06d}.png"), overlay)
    draw_samplevis(raw, cam_k, gt_hand=hands[0], pred_hand=hands[1].reshape(21, 3),
                   gt_points=M.transform_points(model_points[::10], gt[1], gt[2]),
                   pred_points=M.transform_points(model_points[::10], pred[1], pred[2]),
                   save_path=os.path.join(save_path, f"samplevis_{i:06d}.png"))


PredictFn = Callable[[np.ndarray, np.ndarray], object]


def evaluate_model(
    dataset,
    predict_fn: PredictFn,
    config: Config,
    device: DeviceLike = None,
    score_threshold: Optional[float] = None,
    max_eval_images: Optional[int] = None,
    save_path: Optional[str] = None,
) -> EvalResult:
    """Evaluate ``predict_fn`` over every frame of ``dataset``.

    Args:
        dataset: a ``data/colibri.py::ColibriDataset`` or a reader with its protocol.
        predict_fn: (images float32 (B, S, S, 3), cameras float32 (B, 6)) ->
            detections with fields ``boxes``, ``scores``, ``labels``,
            ``rotation``, ``translation``, ``hand`` of leading dims (B, K),
            as tensors or arrays.
        device: where ADD-S runs (``metrics.add_s_batch``); ``None`` is the
            card, and raises when there is none.
        score_threshold: post-hoc filter (defaults to ``config.eval``).
        save_path: a directory for the overlays and sample figures of every
            true positive (``--save-images-path``); the scalars do not
            depend on it.

    Returns the class-mean ``EvalResult``; ``result.per_class`` holds the
    per-label results.
    """
    device = resolve_device(device)
    if save_path is not None:
        os.makedirs(save_path, exist_ok=True)
    ecfg = config.eval
    thr = ecfg.score_threshold if score_threshold is None else score_threshold
    size = len(dataset) if max_eval_images is None else min(len(dataset), max_eval_images)
    eval_batch = max(1, ecfg.eval_batch_size)

    points_by_label = dataset.get_models_3d_points_dict()
    diameters = dataset.get_objects_diameter_dict()
    accs: Dict[int, _ClassAccumulator] = {
        c: _ClassAccumulator(
            points_by_label[c], diameters[c],
            dataset.is_symmetric_object(dataset.class_labels_to_object_ids[c]),
        )
        for c in points_by_label
    }

    chunk: Dict[int, tuple] = {}

    def _detections_for(i: int):
        """Host arrays of frame i's detections, predicting its chunk when it starts."""
        start = (i // eval_batch) * eval_batch
        if start not in chunk:
            s = config.model.image_size
            n = min(eval_batch, size - start)
            images = np.zeros((eval_batch, s, s, 3), np.float32)
            cams = np.zeros((eval_batch, 6), np.float32)
            scales = np.ones(eval_batch, np.float32)
            for k in range(n):
                images[k], scales[k] = preprocess_image(dataset.load_image(start + k), s)
                ck = dataset.load_camera_matrix(start + k)
                cams[k] = [ck[0, 0], ck[1, 1], ck[0, 2], ck[1, 2], 1000.0, scales[k]]
            cams[n:] = cams[0]
            det = predict_fn(images, cams)
            fields = ("boxes", "scores", "labels", "rotation", "translation", "hand")
            host = {f: np.asarray(torch.as_tensor(getattr(det, f)).cpu()) for f in fields}
            chunk.clear()  # one chunk resident
            chunk[start] = (host, scales)
        host, scales = chunk[start]
        k = i - start
        return {f: v[k] for f, v in host.items()}, scales[k]

    for i in range(size):
        raw = dataset.load_image(i) if save_path is not None else None  # the overlays' frame
        cam_k = dataset.load_camera_matrix(i)
        det, scale = _detections_for(i)
        boxes = det["boxes"] / scale
        det_scores, det_labels = det["scores"], det["labels"]
        rotations = det["rotation"] * math.pi
        translations, hands = det["translation"], det["hand"]

        anno = dataset.load_annotations(i)
        anno_labels = anno["labels"].astype(int)

        for c, acc in accs.items():
            keep = np.where((det_scores > thr) & (det_labels == c))[0]
            keep = keep[np.argsort(-det_scores[keep])[: ecfg.max_detections]]

            gsel = np.where(anno_labels == c)[0]
            gt_boxes = anno["bboxes"][gsel]
            acc.num_annotations += gt_boxes.shape[0]
            claimed = set()

            for d in keep:
                acc.scores.append(det_scores[d])
                if gt_boxes.shape[0] == 0:
                    acc.false_positives.append(1)
                    acc.true_positives.append(0)
                    continue
                overlaps = iou_matrix_np(boxes[d: d + 1], gt_boxes)
                j = int(np.argmax(overlaps[0]))
                if not (overlaps[0, j] >= ecfg.iou_threshold and j not in claimed):
                    acc.false_positives.append(1)
                    acc.true_positives.append(0)
                    continue
                claimed.add(j)
                acc.false_positives.append(0)
                acc.true_positives.append(1)
                ja = gsel[j]  # index into the full annotation arrays

                r_gt = np_axis_angle_to_matrix(anno["rotations"][ja, :3])
                t_gt = anno["translations"][ja]
                r_pred = np_axis_angle_to_matrix(rotations[d])
                t_pred = translations[d]

                ok_add, mean_add = M.check_add(
                    acc.model_points, acc.diameter, r_gt, t_gt, r_pred, t_pred, ecfg.diameter_threshold,
                )
                acc.tp_poses.append((r_gt, t_gt, r_pred, t_pred))  # ADD-S runs per class, batched
                # the tip offset is per-object: the matched row's, where the
                # reader gives per-row tips
                tips = np.asarray(
                    anno["drill_tip_transform"] if "drill_tip_transform" in anno
                    else dataset.load_drill_tip_offset(i)
                ).reshape(-1, 4)
                ok_5cm, t_dist, r_dist, tip_dist = M.check_5cm_5degree(
                    r_gt, t_gt, r_pred, t_pred, tips[min(ja, tips.shape[0] - 1)]
                )
                ok_2d = M.check_2d_reprojection(
                    acc.model_points, r_gt, t_gt, r_pred, t_pred, cam_k, ecfg.pixel_threshold,
                )
                # hand predictions live in image_scale-scaled meters (the
                # training targets' space): compare in that space
                hand_err = M.hand_mpjpe_mm(anno["coords_3d"][ja] * scale, hands[d])
                if save_path is not None:
                    infos = getattr(dataset, "models_info", None)
                    _save_images(save_path, i, raw, cam_k,
                                 infos[c] if infos is not None else getattr(dataset, "model_info", None),
                                 acc.model_points, (anno["rotations"][ja, :3], r_gt, t_gt),
                                 (rotations[d], r_pred, t_pred), (gt_boxes[j], boxes[d]),
                                 (anno["coords_3d"][ja], hands[d] / max(scale, 1e-8)))

                acc.tp_add.append(ok_add)
                acc.tp_5cm5deg.append(ok_5cm)
                acc.tp_2d.append(ok_2d)
                acc.t_diffs.append(t_dist)
                acc.r_diffs.append(r_dist)
                acc.tip_diffs.append(tip_dist)
                acc.hand_diffs.append(hand_err)
                acc.point_errors.append(mean_add)

    per_class = {c: acc.finalize(ecfg, device) for c, acc in accs.items()}
    return _aggregate_classes(per_class)
