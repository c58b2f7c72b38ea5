"""Plain float32 EfficientPose phi 0-5: EfficientNet-B0-B5, BiFPN, five heads, anchors.

The benchmark's reference of the network (EfficientPose, arXiv:2011.04307;
HMD-EgoPose, arXiv:2202.11891, is phi = 0), written from the published
architecture in plain ``torch`` with TF32 off, at the widths a configuration
file states (``Widths.of``), over a flat dict of weights
named by the checkpoint's tree paths (``backbone/blocks/3/expand_conv/kernel``,
HWIO kernels) and a dict of BN statistics (``.../mean``, ``.../var``).  It
imports nothing of the program and takes nothing the program made: it reads
the shipped artifact itself (``load_artifact``, int8 leaves dequantized
here) or the weights the benchmark drew.

The backbone is EfficientNet-B0's stage table scaled by the compound
coefficients of B0-B5 (arXiv:1905.11946) as the published implementation
rounds them: filters to a multiple of 8, never under 90 % of the scaled
value; repeats rounded up.  A block's squeeze-excitation is 0.25 times its
input filters; P3-P5 are the last blocks of stages 3, 5 and 7.  The BiFPN
and the heads take the configuration's filters, cell repeats and head
repeats, with fast-attention fusion.  Phi 6-8 (plain-sum fusion, inputs of
1,280 px and up, P8 at phi 8) are not written here: ``Widths.of`` refuses
them.

Published choices kept: TensorFlow SAME padding (the extra pixel low/high
as TF pads), max-pools that pad with zeros, BN eps 1e-3, fast-attention
fusion relu(w) / (sum + 1e-4) then swish, heads whose separable convs are
shared by the levels with a BN per level, outputs flattened location by
location then anchor by anchor.

``fp8=True`` rounds every convolution's input and weights to float8 e4m3
(per-tensor scale to the format's largest value): the control, one
precision below the bfloat16 the serving configuration states.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tree = Dict[str, torch.Tensor]

# EfficientNet-B0 stages: (repeats, kernel, stride, expand, in, out); SE ratio 0.25
B0_STAGES = ((1, 3, 1, 1, 32, 16), (2, 3, 2, 6, 16, 24), (2, 5, 2, 6, 24, 40), (3, 3, 2, 6, 40, 80),
             (3, 5, 1, 6, 80, 112), (4, 5, 2, 6, 112, 192), (1, 3, 1, 6, 192, 320))
STEM_FILTERS = 32
# compound coefficients (width, depth) of EfficientNet-B0-B5, the backbones of EfficientPose phi 0-5
COMPOUND = {"efficientnet-b0": (1.0, 1.0), "efficientnet-b1": (1.0, 1.1), "efficientnet-b2": (1.1, 1.2),
            "efficientnet-b3": (1.2, 1.4), "efficientnet-b4": (1.4, 1.8), "efficientnet-b5": (1.6, 2.2)}
FEATURE_STAGES = (2, 4, 6)  # P3, P4, P5: the last blocks of stages 3, 5, 7
BN_EPS, FUSION_EPS, DROP_CONNECT = 1e-3, 1e-4, 0.2
PYRAMID_LEVELS, ANCHORS_PER_LOCATION = 5, 9


def round_filters(filters: int, width: float) -> int:
    """``filters`` scaled by ``width`` to a multiple of 8, never under 90 % of the scaled value."""
    scaled = filters * width
    rounded = max(8, int(scaled + 4) // 8 * 8)
    return rounded + 8 if rounded < 0.9 * scaled else rounded


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


@dataclasses.dataclass(frozen=True)
class Widths:
    """The network's widths: the backbone by name, the BiFPN's filters and
    cells, the heads' repeats."""

    backbone: str
    fpn_filters: int
    fpn_repeats: int
    head_repeats: int

    @classmethod
    def of(cls, conf: Dict) -> "Widths":
        """From a configuration file's ``backbone``, ``fpn_num_filters``,
        ``fpn_cell_repeats``, ``head_repeats``, ``pyramid_levels`` and
        ``anchors_per_location``; ``ValueError`` where the reference does
        not hold the network."""
        if conf["backbone"] not in COMPOUND:
            raise ValueError(f"{conf['backbone']}: the reference holds EfficientPose phi 0-5 (EfficientNet-B0-B5); "
                             "phi 6-8 fuse by a plain sum, take inputs of 1,280 px and up, and phi 8 adds P8")
        if conf["pyramid_levels"] != PYRAMID_LEVELS or conf["anchors_per_location"] != ANCHORS_PER_LOCATION:
            raise ValueError(f"the reference's anchors are P3-P7 with {ANCHORS_PER_LOCATION} a location, not "
                             f"{conf['pyramid_levels']} levels with {conf['anchors_per_location']}")
        return cls(conf["backbone"], conf["fpn_num_filters"], conf["fpn_cell_repeats"], conf["head_repeats"])

    @property
    def stem(self) -> int:
        return round_filters(STEM_FILTERS, COMPOUND[self.backbone][0])

    def blocks(self) -> List[Dict]:
        """The backbone's MBConv blocks in order: stage, kernel, stride, expand, in, out."""
        width, depth = COMPOUND[self.backbone]
        blocks = []
        for stage, (n, k, s, e, cin, cout) in enumerate(B0_STAGES):
            cin, cout = round_filters(cin, width), round_filters(cout, width)
            for r in range(round_repeats(n, depth)):
                blocks.append({"stage": stage, "kernel": k, "stride": s if r == 0 else 1, "expand": e,
                               "in": cin if r == 0 else cout, "out": cout})
        return blocks

    def features(self) -> Tuple[int, ...]:
        """The filters of P3, P4, P5."""
        width = COMPOUND[self.backbone][0]
        return tuple(round_filters(B0_STAGES[stage][5], width) for stage in FEATURE_STAGES)


def load_artifact(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """The checkpoint's parameters and BN statistics as float32 numpy, the
    int8 leaves dequantized (values times their per-output-channel scale)."""
    params, stats = {}, {}
    with np.load(path) as data:
        int8 = "__format__" in data.files and str(data["__format__"]) == "int8"
        for key in data.files:
            if key.startswith("bn/"):
                stats[key[3:]] = data[key].astype(np.float32)
            elif key.startswith("params/"):
                name = key[len("params/"):]
                if not int8:
                    params[name] = data[key].astype(np.float32)
                elif name.endswith("/fp32"):
                    params[name[:-5]] = data[key].astype(np.float32)
                elif name.endswith("/int8"):
                    q = data[key].astype(np.float32)
                    params[name[:-5]] = q * data[key[:-5] + "/scales"].astype(np.float32)
    return params, stats


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Net:
    """The network of ``widths`` over weights ``P`` and BN statistics ``S``; ``training``
    normalises with batch statistics (variance E[x^2] - E[x]^2)."""

    def __init__(self, widths: Widths, P: Tree, S: Optional[Tree] = None, training: bool = False,
                 fp8: bool = False):
        self.widths, self.P, self.S, self.training, self.fp8 = widths, P, S or {}, training, fp8

    def conv(self, x: torch.Tensor, name: str, stride: int = 1, depthwise: bool = False,
             bias: bool = True) -> torch.Tensor:
        k = self.P[name + "/kernel"]  # HWIO; a depthwise kernel is (kh, kw, 1, C)
        w = k.permute(3, 2, 0, 1)
        size = k.shape[0]
        pads = []
        for dim in (x.shape[-1], x.shape[-2]):
            out = -(-dim // stride)
            extra = max((out - 1) * stride + size - dim, 0)
            pads += [extra // 2, extra - extra // 2]
        if any(pads):
            x = F.pad(x, pads)
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        b = self.P.get(name + "/bias") if bias else None
        return F.conv2d(x, w, b, stride, 0, 1, x.shape[1] if depthwise else 1)

    def bn(self, x: torch.Tensor, name: str, stats: Optional[str] = None) -> torch.Tensor:
        scale, bias = self.P[name + "/scale"], self.P[name + "/bias"]
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
        else:
            key = stats or name
            mean, var = self.S[key + "/mean"], self.S[key + "/var"]
        inv = torch.rsqrt(var + BN_EPS) * scale
        return (x - mean[:, None, None]) * inv[:, None, None] + bias[:, None, None]

    @staticmethod
    def swish(x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(x)

    def sep(self, x: torch.Tensor, name: str, norm: bool = True) -> torch.Tensor:
        x = self.conv(self.conv(x, name + "/depthwise", depthwise=True, bias=False), name + "/pointwise")
        return self.bn(x, name + "/bn") if norm else x

    # -- EfficientNet ----------------------------------------------------------
    def backbone(self, x: torch.Tensor, drop: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """``drop``: (blocks, B) uniforms of drop-connect in training: block i
        keeps example b where ``drop[i, b] < 1 - 0.2 * i / blocks``."""
        x = self.swish(self.bn(self.conv(x, "backbone/stem_conv", stride=2, bias=False), "backbone/stem_bn"))
        blocks, feats = self.widths.blocks(), []
        for i, spec in enumerate(blocks):
            p, inputs = f"backbone/blocks/{i}", x
            if spec["expand"] != 1:
                x = self.swish(self.bn(self.conv(x, p + "/expand_conv", bias=False), p + "/bn0"))
            x = self.swish(self.bn(self.conv(x, p + "/depthwise_conv", spec["stride"], True, False), p + "/bn1"))
            se = x.mean(dim=(2, 3), keepdim=True)
            se = self.conv(self.swish(self.conv(se, p + "/se_reduce")), p + "/se_expand")
            x = torch.sigmoid(se) * x
            x = self.bn(self.conv(x, p + "/project_conv", bias=False), p + "/bn2")
            if spec["stride"] == 1 and spec["in"] == spec["out"]:
                keep = 1.0 - DROP_CONNECT * i / len(blocks)
                if drop is not None and self.training and keep < 1.0:
                    x = x / keep * (drop[i] < keep).to(x.dtype)[:, None, None, None]
                x = x + inputs
            last = i + 1 == len(blocks) or blocks[i + 1]["stage"] != spec["stage"]
            if last and spec["stage"] in FEATURE_STAGES:
                feats.append(x)
        return feats

    # -- BiFPN -------------------------------------------------------------------
    @staticmethod
    def pool(x: torch.Tensor) -> torch.Tensor:
        pads = []
        for dim in (x.shape[-1], x.shape[-2]):
            extra = max((-(-dim // 2) - 1) * 2 + 3 - dim, 0)
            pads += [extra // 2, extra - extra // 2]
        return F.max_pool2d(F.pad(x, pads), 3, 2)

    def fuse(self, name: str, xs: List[torch.Tensor]) -> torch.Tensor:
        w = F.relu(self.P[name])
        w = w / (w.sum() + FUSION_EPS)
        return self.swish(sum(w[i] * t for i, t in enumerate(xs)))

    def bifpn(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        for c in range(self.widths.fpn_repeats):
            p = f"bifpn/cells/{c}/"
            if c == 0:
                p3, p4, p5 = feats
                align = lambda t, n: self.bn(self.conv(t, p + n + "/conv"), p + n + "/bn")  # noqa: E731
                p6_in = self.pool(align(p5, "p5_to_p6"))
                p7_in = self.pool(p6_in)
                p3_in, p4_in, p5_in = align(p3, "p3_down_channel"), align(p4, "p4_down_channel"), align(
                    p5, "p5_down_channel")
            else:
                p3_in, p4_in, p5_in, p6_in, p7_in = feats
            p6_up = self.sep(self.fuse(p + "p6_w1", [p6_in, up(p7_in)]), p + "conv6_up")
            p5_up = self.sep(self.fuse(p + "p5_w1", [p5_in, up(p6_up)]), p + "conv5_up")
            p4_up = self.sep(self.fuse(p + "p4_w1", [p4_in, up(p5_up)]), p + "conv4_up")
            p3_out = self.sep(self.fuse(p + "p3_w1", [p3_in, up(p4_up)]), p + "conv3_up")
            if c == 0:
                p4_in, p5_in = align(p4, "p4_down_channel_2"), align(p5, "p5_down_channel_2")
            p4_out = self.sep(self.fuse(p + "p4_w2", [p4_in, p4_up, self.pool(p3_out)]), p + "conv4_down")
            p5_out = self.sep(self.fuse(p + "p5_w2", [p5_in, p5_up, self.pool(p4_out)]), p + "conv5_down")
            p6_out = self.sep(self.fuse(p + "p6_w2", [p6_in, p6_up, self.pool(p5_out)]), p + "conv6_down")
            p7_out = self.sep(self.fuse(p + "p7_w2", [p7_in, self.pool(p6_out)]), p + "conv7_down")
            feats = [p3_out, p4_out, p5_out, p6_out, p7_out]
        return feats

    # -- heads -------------------------------------------------------------------
    def head(self, pyramid: List[torch.Tensor], name: str, headers: Tuple[Tuple[str, int], ...]) -> torch.Tensor:
        outs = []
        for lv, feat in enumerate(pyramid):
            for j in range(self.widths.head_repeats):
                feat = self.swish(self.bn(self.sep(feat, f"{name}/convs/{j}", norm=False), f"{name}/bns/{lv}/{j}"))
            parts = []
            for header, dim in headers:
                y = self.sep(feat, f"{name}/{header}", norm=False)
                parts.append(y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, dim))
            outs.append(torch.cat(parts, dim=-1))
        return torch.cat(outs, dim=1)

    def forward(self, images_nhwc: torch.Tensor, drop: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Preprocessed NHWC images -> the five head outputs, (B, N, ...):
        regression, classification (sigmoid), rotation (axis-angle / pi),
        translation_raw (dx, dy, tz), hand."""
        pyramid = self.bifpn(self.backbone(images_nhwc.permute(0, 3, 1, 2), drop))
        return {
            "regression": self.head(pyramid, "regressor", (("header", 4),)),
            "classification": torch.sigmoid(self.head(pyramid, "classifier", (("header", 1),))),
            "rotation": self.head(pyramid, "rotation", (("header", 3),)),
            "translation_raw": self.head(pyramid, "translation", (("header_xy", 2), ("header_z", 1))),
            "hand": self.head(pyramid, "hand", (("header", 63),)),
        }


# -- anchors, preprocessing, decode ---------------------------------------------

def anchors(image_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """EfficientDet anchors P3-P7 (sizes 32-512, strides 8-128, ratios 1, 1/2,
    2, scales 2^(0, 1/3, 2/3)): (N, 4) boxes x1 y1 x2 y2 and (N, 3) translation
    anchors (cx, cy, stride), location by location, anchor i of a location
    at scale i // 3 and ratio i % 3."""
    boxes, trans = [], []
    ratios = np.array([1.0, 0.5, 2.0])
    scales = 2.0 ** (np.arange(3) / 3.0)
    for level in range(3, 8):
        stride, size = 2 ** level, 4 * 2 ** level
        fm = -(-image_size // stride)
        i = np.arange(9)
        side = size * scales[i // 3]
        w = np.sqrt(side * side / ratios[i % 3])
        h = w * ratios[i % 3]
        cy, cx = np.meshgrid((np.arange(fm) + 0.5) * stride, (np.arange(fm) + 0.5) * stride, indexing="ij")
        c = np.stack([cx.ravel(), cy.ravel()], axis=1)[:, None, :]
        boxes.append(np.concatenate([c - np.stack([w, h], 1)[None] / 2, c + np.stack([w, h], 1)[None] / 2],
                                    axis=-1).reshape(-1, 4))
        trans.append(np.concatenate([np.repeat(c[:, 0], 9, axis=0), np.full((fm * fm * 9, 1), stride)], axis=1))
    return np.concatenate(boxes).astype(np.float32), np.concatenate(trans).astype(np.float32)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess(frames_u8: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, size, size, 3) float32: aspect-preserving
    bilinear resize (half-pixel centres, no antialiasing), rounded to uint8
    levels, / 255, ImageNet normalisation, zero pad at the bottom and right."""
    b, h, w, _ = frames_u8.shape
    rh, rw = (size, int(w * size / h)) if h > w else (int(h * size / w), size)
    x = frames_u8.permute(0, 3, 1, 2).float()
    if (rh, rw) != (h, w):
        x = torch.round(F.interpolate(x, size=(rh, rw), mode="bilinear", align_corners=False))
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    x = (x / 255.0 - mean) / std
    x = F.pad(x, (0, size - rw, 0, size - rh))
    return x.permute(0, 2, 3, 1)


def i420_to_rgb(payload: bytes, height: int, width: int) -> np.ndarray:
    """I420 (BT.601 limited range) -> (H, W, 3) uint8 RGB, chroma repeated 2x2."""
    a = np.frombuffer(payload, np.uint8)
    n = height * width
    y = a[:n].reshape(height, width).astype(np.int32) - 16
    u = a[n:n + n // 4].reshape(height // 2, width // 2).astype(np.int32).repeat(2, 0).repeat(2, 1) - 128
    v = a[n + n // 4:].reshape(height // 2, width // 2).astype(np.int32).repeat(2, 0).repeat(2, 1) - 128
    r = (298 * y + 409 * v + 128) >> 8
    g = (298 * y - 100 * u - 208 * v + 128) >> 8
    b = (298 * y + 516 * u + 128) >> 8
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_poses(out: Dict[str, torch.Tensor], trans_anchors: torch.Tensor, cameras: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every anchor's score, rotation (radians) and translation (m), from
    the head outputs and cameras (B, 6) [fx, fy, px, py, tz scale, image scale]:
    the anchor-relative centre back-projected through the pinhole camera."""
    t = out["translation_raw"]
    stride = trans_anchors[:, 2]
    x = (trans_anchors[:, 0] + t[..., 0] * stride) / cameras[:, 5:6] - cameras[:, 2:3]
    y = (trans_anchors[:, 1] + t[..., 1] * stride) / cameras[:, 5:6] - cameras[:, 3:4]
    tz = t[..., 2] * cameras[:, 4:5]
    trans = torch.stack([x * tz / cameras[:, 0:1], y * tz / cameras[:, 1:2], tz], dim=-1) / 1000.0
    return out["classification"].amax(dim=-1), out["rotation"] * math.pi, trans
