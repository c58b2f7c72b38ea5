"""The parameter tree of EfficientPose phi 0-5 at a configuration's widths
(``reference/model.py``'s ``Widths``), by path and shape.

Paths are the checkpoint's (``backbone/blocks/3/expand_conv/kernel``),
kernels HWIO, a depthwise kernel (kh, kw, 1, C).  ``draw`` makes a tree of
random weights from one generator in one call: He-normal kernels, zero
biases, BN scale 1 and bias 0, fusion weights 1, the classifier's header
bias at the focal-loss prior (p = 0.01); BN statistics mean 0, variance 1.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Tuple

from reference.model import ANCHORS_PER_LOCATION, PYRAMID_LEVELS, Widths

CLASSIFIER_PRIOR = -math.log((1 - 0.01) / 0.01)
HEAD_OUTPUTS = {"regressor": (("header", 4),), "classifier": (("header", 1),), "rotation": (("header", 3),),
                "translation": (("header_xy", 2), ("header_z", 1)), "hand": (("header", 63),)}
FUSION = (("p6_w1", 2), ("p5_w1", 2), ("p4_w1", 2), ("p3_w1", 2), ("p4_w2", 3), ("p5_w2", 3), ("p6_w2", 3),
          ("p7_w2", 2))


def param_shapes(widths: Widths) -> "OrderedDict[str, Tuple[int, ...]]":
    shapes: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()

    def conv(name, k, cin, cout, bias=True):
        shapes[name + "/kernel"] = (k, k, cin, cout)
        if bias:
            shapes[name + "/bias"] = (cout,)

    def bn(name, c):
        shapes[name + "/scale"] = (c,)
        shapes[name + "/bias"] = (c,)

    def sep(name, cin, cout, norm=True):
        shapes[name + "/depthwise/kernel"] = (3, 3, 1, cin)
        conv(name + "/pointwise", 1, cin, cout)
        if norm:
            bn(name + "/bn", cout)

    conv("backbone/stem_conv", 3, 3, widths.stem, bias=False)
    bn("backbone/stem_bn", widths.stem)
    for i, s in enumerate(widths.blocks()):
        p, mid = f"backbone/blocks/{i}", s["in"] * s["expand"]
        if s["expand"] != 1:
            conv(p + "/expand_conv", 1, s["in"], mid, bias=False)
            bn(p + "/bn0", mid)
        shapes[p + "/depthwise_conv/kernel"] = (s["kernel"], s["kernel"], 1, mid)
        bn(p + "/bn1", mid)
        se = max(1, int(s["in"] * 0.25))
        conv(p + "/se_reduce", 1, mid, se)
        conv(p + "/se_expand", 1, se, mid)
        conv(p + "/project_conv", 1, mid, s["out"], bias=False)
        bn(p + "/bn2", s["out"])
    ch, (p3, p4, p5) = widths.fpn_filters, widths.features()
    for c in range(widths.fpn_repeats):
        p = f"bifpn/cells/{c}/"
        for name in ("conv6_up", "conv5_up", "conv4_up", "conv3_up", "conv4_down", "conv5_down", "conv6_down",
                     "conv7_down"):
            sep(p + name, ch, ch)
        if c == 0:
            for name, cin in (("p3_down_channel", p3), ("p4_down_channel", p4), ("p5_down_channel", p5),
                              ("p4_down_channel_2", p4), ("p5_down_channel_2", p5), ("p5_to_p6", p5)):
                conv(p + name + "/conv", 1, cin, ch)
                bn(p + name + "/bn", ch)
        for name, n in FUSION:
            shapes[p + name] = (n,)
    for head, headers in HEAD_OUTPUTS.items():
        for j in range(widths.head_repeats):
            sep(f"{head}/convs/{j}", ch, ch, norm=False)
        for lv in range(PYRAMID_LEVELS):
            for j in range(widths.head_repeats):
                bn(f"{head}/bns/{lv}/{j}", ch)
        for header, dim in headers:
            sep(f"{head}/{header}", ch, ANCHORS_PER_LOCATION * dim, norm=False)
    return shapes


def stat_names(widths: Widths) -> Dict[str, int]:
    """BN statistics prefix -> channels."""
    return {k[:-len("/scale")]: v[0] for k, v in param_shapes(widths).items() if k.endswith("/scale")}


def draw(generator, device, widths: Widths) -> Tuple[Dict, Dict]:
    """(params, stats) of random weights of ``widths`` as float32 tensors on
    ``device``, from one normal draw of ``generator`` (a ``torch.Generator`` there)."""
    import torch

    shapes = param_shapes(widths)
    kernels = [k for k in shapes if k.endswith("/kernel")]
    sizes = [math.prod(shapes[k]) for k in kernels]
    normal = torch.randn(sum(sizes), generator=generator, device=device)
    params, offset = {}, 0
    for name, size in zip(kernels, sizes):
        shape = shapes[name]
        params[name] = normal[offset:offset + size].view(shape) * math.sqrt(2.0 / (shape[0] * shape[1] * shape[2]))
        offset += size
    for name, shape in shapes.items():
        if name in params:
            continue
        fill = 1.0 if name.endswith("/scale") or name.rsplit("/", 1)[-1] in dict(FUSION) else 0.0
        params[name] = torch.full(shape, fill, device=device)
    params["classifier/header/pointwise/bias"].fill_(CLASSIFIER_PRIOR)
    stats = {}
    for prefix, c in stat_names(widths).items():
        stats[prefix + "/mean"] = torch.zeros(c, device=device)
        stats[prefix + "/var"] = torch.ones(c, device=device)
    return params, stats
