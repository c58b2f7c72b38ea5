"""HMDEgoPose: EfficientNet + BiFPN + five anchor heads, and ``predict``.

Counterpart of ``hmd_ego_pose_tpu/models/hmd_ego_pose.py``.  ``apply`` takes
NHWC images (the JAX package's layout, so both sides take the same arrays),
casts them to ``config.compute_dtype`` and runs the network in NCHW; the five
head outputs come back in float32.  ``predict`` adds top-k, decode, greedy
NMS and, for ``hand_relative`` models, the re-anchoring of the hand joints
on the predicted translation.

On a mesh with a space axis (the model's ``mesh``, ``parallel/mesh.py``)
the images are the rank's slab of rows of its data rows
(``image_sharding``), and the five head outputs, and so decode, top-k and
NMS, are whole on every rank of the space group; ``RawOutputs.features``
stays the rank's slabs.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from hmd_ego_pose_tpu_torch.config import ModelConfig
from hmd_ego_pose_tpu_torch.models.bifpn import BiFPN
from hmd_ego_pose_tpu_torch.models.efficientnet import Backbone
from hmd_ego_pose_tpu_torch.models.heads import CLASSIFIER_BIAS_PRIOR, Head, TranslationHead
from hmd_ego_pose_tpu_torch.nn.core import BatchNorm, Conv2dSame, sigmoid
from hmd_ego_pose_tpu_torch.ops.anchors import device_anchors
from hmd_ego_pose_tpu_torch.ops.decode import hand_to_absolute
from hmd_ego_pose_tpu_torch.ops.nms import Detections, filter_detections_fused_batch
from hmd_ego_pose_tpu_torch.parallel.mesh import LOCAL
from hmd_ego_pose_tpu_torch.utils.device import dtype_of


class RawOutputs(NamedTuple):
    features: Tuple[torch.Tensor, ...]  # 5-level pyramid, NCHW, compute dtype
    regression: torch.Tensor  # (B, N, 4)
    classification: torch.Tensor  # (B, N, num_classes), sigmoided
    rotation: torch.Tensor  # (B, N, 3) axis-angle / pi
    translation_raw: torch.Tensor  # (B, N, 3) anchor-relative (dx, dy, tz)
    hand: torch.Tensor  # (B, N, 63)


class HMDEgoPose(nn.Module):
    """The full network with the reference's state_dict naming."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        ch, levels, repeats = config.fpn_num_filters, config.num_pyramid_levels, config.head_repeats
        na, eps, it = config.num_anchors_per_location, config.bn_epsilon, config.iter_steps
        self.dtype = dt = dtype_of(config.compute_dtype)
        self.backbone_net = Backbone(config.backbone_coefficient, eps, dt, config.remat_backbone)
        self.bifpn = BiFPN(ch, config.conv_channels, config.fpn_cell_repeats,
                           attention=config.phi < 6, eps=eps, fusion_eps=config.fusion_epsilon,
                           dtype=dt)
        self.regressor = Head(ch, 4, na, repeats, levels, eps=eps, dtype=dt)
        self.classifier = Head(ch, config.num_classes, na, repeats, levels, eps=eps, dtype=dt)
        self.rotation_net = Head(ch, config.num_rotation_parameters, na, repeats, levels,
                                 header_name="initial_rotation", iter_steps=it, eps=eps, dtype=dt)
        self.translation_net = TranslationHead(ch, na, repeats, levels, iter_steps=it, eps=eps,
                                               dtype=dt)
        self.hand_net = Head(ch, config.num_hand_parameters, na, repeats, levels,
                             header_name="initial_hand_coords", iter_steps=it, eps=eps, dtype=dt)
        self.mesh = LOCAL

    def input_height(self, x: torch.Tensor) -> int:
        """The whole height of the NCHW input ``x``: its own without a space
        axis, else ``config.image_size``, of which ``x`` must hold the rank's rows."""
        if self.mesh.space == 1:
            return x.shape[-2]
        h = self.config.image_size
        rows = self.mesh.height_rows(h)
        if x.shape[-2] != rows.stop - rows.start:
            raise ValueError(f"space rank {self.mesh.space_rank} of {self.mesh.space} holds rows {rows} of "
                             f"{h}, not {x.shape[-2]} rows")
        return h

    def forward(self, x: torch.Tensor, capture: Optional[dict] = None,
                generator: Optional[torch.Generator] = None, drop: Optional[torch.Tensor] = None
                ) -> RawOutputs:
        """NCHW float input -> raw outputs (the conv stack runs in ``config.compute_dtype``).

        ``generator`` draws the backbone's drop-connect masks in training mode,
        or ``drop`` holds their uniforms drawn ahead (``models/efficientnet.py``)."""
        h = self.input_height(x)
        heights = [-(-h // 2 ** level) for level in range(3, 8)]  # P3..P7, SAME strides of 2
        feats = self.backbone_net(x, generator, h, drop)
        if capture is not None:
            capture["backbone.p3"], capture["backbone.p4"], capture["backbone.p5"] = feats
        pyramid = self.bifpn(feats, capture, heights)
        return RawOutputs(
            features=tuple(pyramid),
            regression=self.regressor(pyramid, heights).float(),
            classification=sigmoid(self.classifier(pyramid, heights), self.dtype).float(),
            rotation=self.rotation_net(pyramid, heights).float(),
            translation_raw=self.translation_net(pyramid, heights).float(),
            hand=self.hand_net(pyramid, heights).float(),
        )


def init_weights(model: HMDEgoPose, generator: torch.Generator) -> HMDEgoPose:
    """Random weights: He-normal convs, zero biases, identity BN, fusion weights 1,
    and the classifier header bias at the focal-loss prior (p = 0.01)."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Conv2dSame):
                w = module.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                w.copy_(torch.randn(w.shape, generator=generator) * math.sqrt(2.0 / fan_in))
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        model.classifier.header.pointwise_conv.conv.bias.fill_(CLASSIFIER_BIAS_PRIOR)
    return model


def apply(model: HMDEgoPose, images: torch.Tensor, config: ModelConfig,
          capture: Optional[dict] = None) -> RawOutputs:
    """Preprocessed NHWC float images -> raw head outputs (float32), no autograd,
    the model in eval mode (BNs on their running statistics), on the model's
    mesh (``parallel/mesh.py::replicate`` or ``attach`` puts it there):
    ``images`` are this rank's slab of its data rows."""
    model.eval()
    x = images.permute(0, 3, 1, 2).to(dtype_of(config.compute_dtype))
    with torch.inference_mode():
        return model(x, capture)


def apply_train(model: HMDEgoPose, images: torch.Tensor, config: ModelConfig,
                generator: Optional[torch.Generator] = None, drop: Optional[torch.Tensor] = None
                ) -> RawOutputs:
    """The training forward (``apply(training=True, rng)`` of the JAX package):
    NHWC images -> raw outputs with autograd, every BN on batch statistics and
    moving its running statistics in place, drop-connect drawn from
    ``generator``, or from its uniforms ``drop`` drawn ahead
    (``models/efficientnet.py::drop_connect_uniforms``), off without either.
    Puts the whole model in training mode,
    the frozen backbone included: its BNs move as the JAX package's do.
    On the model's mesh, as ``apply``."""
    model.train()
    x = images.permute(0, 3, 1, 2).to(dtype_of(config.compute_dtype))
    return model(x, generator=generator, drop=drop)


def detect(
    outputs: RawOutputs,
    camera_parameters: torch.Tensor,
    config: ModelConfig,
    score_threshold: float = 0.5,
    iou_threshold: float = 0.5,
    max_detections: int = 100,
) -> Detections:
    """Raw outputs -> top-k -> decode of the candidates -> greedy NMS
    (-> hand re-anchoring for ``hand_relative`` models)."""
    device = outputs.regression.device
    anchors, trans_anchors = device_anchors(config.image_size, config.anchors, device)
    with torch.inference_mode():
        dets = filter_detections_fused_batch(
            outputs.regression,
            outputs.classification,
            outputs.rotation,
            outputs.translation_raw,
            outputs.hand,
            anchors,
            trans_anchors,
            camera_parameters.to(device=device, dtype=torch.float32),
            config.image_size,
            config.image_size,
            score_threshold=score_threshold,
            iou_threshold=iou_threshold,
            max_detections=max_detections,
        )
        if config.hand_relative:
            dets = dets._replace(hand=hand_to_absolute(dets.hand, dets.translation))
    return dets


def predict(
    model: HMDEgoPose,
    images: torch.Tensor,
    camera_parameters: torch.Tensor,
    config: ModelConfig,
    score_threshold: float = 0.5,
    iou_threshold: float = 0.5,
    max_detections: int = 100,
) -> Detections:
    """Forward, then ``detect``.  ``rotation`` stays in the network's units
    (times pi for radians).  On a mesh (as for ``apply``) the cameras are
    this rank's data rows, and every rank of the space group detects on the
    same whole outputs."""
    return detect(apply(model, images, config), camera_parameters, config,
                  score_threshold, iou_threshold, max_detections)
