"""Model, anchor, evaluation and serving configuration for the PyTorch port.

A copy of the configuration dataclasses and per-phi tables of
``hmd_ego_pose_tpu/config.py`` that inference and evaluation need.  The port keeps its own
copy so it never imports the JAX package; the values must stay identical
(tests/test_torch_model.py compares the derived quantities).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Anchor pyramid: levels P3..P7, 3 ratios x 3 scales per location."""

    sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    ratios: Tuple[float, ...] = (1.0, 0.5, 2.0)
    scales: Tuple[float, ...] = (2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0))
    pyramid_levels: Tuple[int, ...] = (3, 4, 5, 6, 7)

    @property
    def num_anchors_per_location(self) -> int:
        return len(self.ratios) * len(self.scales)

    def num_anchors(self, image_size: int) -> int:
        total = 0
        for level in self.pyramid_levels:
            fm = (image_size + 2 ** level - 1) // (2 ** level)
            total += fm * fm * self.num_anchors_per_location
        return total


# Per-phi scaling tables.
_BACKBONE_COMPOUND = (0, 1, 2, 3, 4, 5, 6, 6, 7)
_FPN_FILTERS = (64, 88, 112, 160, 224, 288, 384, 384, 384)
_FPN_REPEATS = (3, 4, 5, 6, 7, 7, 8, 8, 8)
_HEAD_REPEATS = (3, 3, 3, 4, 4, 4, 5, 5, 5)
_PYRAMID_LEVELS = (5, 5, 5, 5, 5, 5, 5, 5, 6)
# P3/P4/P5 channel widths out of each EfficientNet backbone.
_CONV_CHANNELS = {
    0: (40, 112, 320),
    1: (40, 112, 320),
    2: (48, 120, 352),
    3: (48, 136, 384),
    4: (56, 160, 448),
    5: (64, 176, 512),
    6: (72, 200, 576),
    7: (80, 224, 640),
}

# EfficientNet compound scaling: coefficient -> (width, depth, resolution, dropout)
EFFICIENTNET_PARAMS = {
    0: (1.0, 1.0, 224, 0.2),
    1: (1.0, 1.1, 240, 0.2),
    2: (1.1, 1.2, 260, 0.3),
    3: (1.2, 1.4, 300, 0.3),
    4: (1.4, 1.8, 380, 0.4),
    5: (1.6, 2.2, 456, 0.4),
    6: (1.8, 2.6, 528, 0.5),
    7: (2.0, 3.1, 600, 0.5),
}

# Base MBConv stage spec: (num_repeat, kernel, stride, expand, in, out, se_ratio)
MBCONV_STAGES = (
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """HMDEgoPose hyper-parameters for a given phi (inference subset)."""

    phi: int = 0
    num_classes: int = 1
    image_size: int = 256
    num_rotation_parameters: int = 3
    num_translation_parameters: int = 3
    num_hand_parameters: int = 63  # 21 joints x 3
    iter_steps: int = 0
    anchors: AnchorConfig = dataclasses.field(default_factory=AnchorConfig)
    bn_momentum: float = 0.01
    bn_epsilon: float = 1e-3
    fusion_epsilon: float = 1e-4
    # compute dtype of the conv stack; parameters and BN statistics stay float32
    compute_dtype: str = "float32"
    # the hand head regresses joint offsets from the predicted object
    # translation; predict re-anchors them (models/hmd_ego_pose.py)
    hand_relative: bool = False

    def __post_init__(self):
        if not 0 <= self.phi <= 8:
            raise ValueError(f"phi must be in [0, 8], got {self.phi}")

    @property
    def backbone_coefficient(self) -> int:
        return _BACKBONE_COMPOUND[self.phi]

    @property
    def fpn_num_filters(self) -> int:
        return _FPN_FILTERS[self.phi]

    @property
    def fpn_cell_repeats(self) -> int:
        return _FPN_REPEATS[self.phi]

    @property
    def head_repeats(self) -> int:
        return _HEAD_REPEATS[self.phi]

    @property
    def num_pyramid_levels(self) -> int:
        return _PYRAMID_LEVELS[self.phi]

    @property
    def conv_channels(self) -> Tuple[int, int, int]:
        return _CONV_CHANNELS[self.backbone_coefficient]

    @property
    def num_anchors_per_location(self) -> int:
        return self.anchors.num_anchors_per_location

    @property
    def total_anchors(self) -> int:
        return self.anchors.num_anchors(self.image_size)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    score_threshold: float = 0.5
    nms_threshold: float = 0.5
    max_detections: int = 100
    iou_threshold: float = 0.5
    diameter_threshold: float = 0.1
    pixel_threshold: float = 5.0  # 2-D reprojection metric
    adds_max_points: int = 1000
    # frames per forward of the evaluator (the tail chunk is padded)
    eval_batch_size: int = 8


@dataclasses.dataclass(frozen=True)
class Config:
    """The parts of the JAX package's ``Config`` that evaluation reads."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    batch_size: int = 1
    max_batch_size: int = 16
    score_threshold: float = 0.5
    port: int = 18734
    # wire format: 24-byte little-endian packet of 6 float32 [rvec, tvec]
    pose_packet_floats: int = 6
    queue_depth: int = 64
