"""Follow the program's first training steps in plain float32 and compare.

The reference step (EfficientPose's training, arXiv:2011.04307, as the
HMD-EgoPose reference trains it): gather the batch from the benchmark's own
frames and labels, colour and 6-DoF augmentation from the step's draws
(``reference/augment.py``), preprocess, the training forward (every BN on
batch statistics, drop-connect from the step's uniforms), anchor targets
(IoU >= 0.5 positive and each object's best anchor forced positive,
0.4-0.5 and out-of-image anchors ignored), the loss (focal 1.0, box
smooth-L1 50, rotation point distance 100, translation smooth-L1 0.1, hand
smooth-L1 1.0; the hand relative to the object's translation), the
backward of the trained leaves (the backbone frozen), and Adam (0.9, 0.999,
1e-8, bias-corrected).

``follow`` returns, of each step, the six losses; the first step's
gradient of each trained leaf; and each leaf's change after the last step.
``compare`` reduces them against the program's to the numbers ``correct``
holds: the widest relative gap of a loss, and per leaf the gap between the
program's norm and the reference's, over the larger of that leaf's
reference norm and the median leaf's (leaves whose reference gradient is
under a thousandth of the median leaf's are left out of both).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from reference import augment
from reference.model import Net, Widths, anchors, preprocess

ADAM = (0.9, 0.999, 1e-8)
LOSS_WEIGHTS = {"classification": 1.0, "regression": 50.0, "rotation": 100.0, "translation": 0.1, "hand": 1.0}
LOSS_NAMES = ("loss", "classification_loss", "regression_loss", "rotation_loss", "translation_loss", "hand_loss")


def _smooth_l1(diff, sigma):
    s2 = sigma * sigma
    a = diff.abs()
    return torch.where(a <= 1.0 / s2, 0.5 * s2 * a * a, a - 0.5 / s2)


def targets(anchor_boxes, boxes, transformation, coords, image_size):
    """Per-anchor targets of B images with one object each: (labels, regression,
    transformation, coords, state), state -1 ignore, 0 negative, 1 positive."""
    a = anchor_boxes[None, :, :]
    b = boxes[:, None, :]
    iw = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    ih = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0)
    inter = iw * ih
    union = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]) + (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
             - inter)
    iou = torch.where(union > 0, inter / union, torch.zeros_like(inter))  # (B, N)
    positive = iou >= 0.5
    positive[torch.arange(iou.shape[0]), iou.argmax(dim=1)] = True
    ignore = (iou > 0.4) & ~positive
    cx = (anchor_boxes[:, 0] + anchor_boxes[:, 2]) / 2
    cy = (anchor_boxes[:, 1] + anchor_boxes[:, 3]) / 2
    outside = ((cx >= image_size) | (cy >= image_size))[None]
    state = positive.float()
    state = torch.where(ignore | outside, torch.full_like(state, -1.0), state)
    eps = 1e-7
    wa, ha = a[..., 2] - a[..., 0], a[..., 3] - a[..., 1]
    cxa, cya = a[..., 0] + wa / 2, a[..., 1] + ha / 2
    w, h = b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]
    cxb, cyb = b[..., 0] + w / 2, b[..., 1] + h / 2
    ha, wa, h, w = ha + eps, wa + eps, h + eps, w + eps
    regression = torch.stack([(cyb - cya) / ha, (cxb - cxa) / wa, torch.log(h / ha), torch.log(w / wa)], dim=-1)
    n = anchor_boxes.shape[0]
    return ((state == 1.0).float()[..., None], regression, transformation[:, None, :].expand(-1, n, -1),
            coords[:, None, :].expand(-1, n, -1), state)


def _rotate(points, rotvec):
    """(B, P, Q, 3) points by (B, P, 3) rotation vectors (Rodrigues)."""
    angle = rotvec.norm(dim=-1, keepdim=True)
    axis = rotvec / angle.clamp(min=1e-12)
    cos, sin = torch.cos(angle)[..., None, :], torch.sin(angle)[..., None, :]
    k = axis[..., None, :].expand_as(points)
    return (points * cos + torch.cross(k, points, dim=-1) * sin
            + k * (k * points).sum(dim=-1, keepdim=True) * (1 - cos))


def losses(out, translation_mm, tg, points, cap: int = 64) -> Dict[str, torch.Tensor]:
    labels, regression, transformation, coords, state = tg
    pos = state == 1.0
    npos = pos.sum(dim=1).float().clamp(min=1.0)
    cls = out["classification"].clamp(1e-4, 1 - 1e-4)
    one = labels == 1.0
    weight = torch.where(one, torch.full_like(cls, 0.25), torch.full_like(cls, 0.75))
    weight = weight * torch.where(one, 1 - cls, cls) ** 1.5
    bce = -(labels * torch.log(cls) + (1 - labels) * torch.log(1 - cls))
    focal = (weight * bce * (state != -1.0)[..., None]).sum(dim=(1, 2)) / npos
    box = (_smooth_l1(out["regression"] - regression, 3.0) * pos[..., None]).sum(dim=(1, 2)) / npos
    hand = (_smooth_l1(out["hand"] - coords, 3.0) * pos[..., None]).sum(dim=(1, 2)) / npos
    # the transformation loss reads the first ``cap`` positive anchors of each image
    order = torch.sort(pos.float(), dim=1, descending=True, stable=True).indices[:, :cap]
    valid = torch.gather(pos, 1, order).float()
    take = lambda x: torch.gather(x, 1, order[..., None].expand(-1, -1, x.shape[-1]))  # noqa: E731
    rot_pred = take(out["rotation"]) * math.pi
    rot_gt = take(transformation)[..., :3] * math.pi
    pts = points[None, None].expand(rot_pred.shape[0], rot_pred.shape[1], -1, -1)
    dist = (_rotate(pts, rot_pred) - _rotate(pts, rot_gt)).norm(dim=-1).mean(dim=-1)
    capped = valid.sum(dim=1).clamp(min=1.0)
    has = pos.any(dim=1)
    rotation = torch.where(has, (dist * valid).sum(dim=1) / capped, torch.zeros_like(capped))
    t_elem = _smooth_l1(take(translation_mm) - take(transformation)[..., 3:6], 1.0) * valid[..., None]
    translation = torch.where(has, t_elem.sum(dim=(1, 2)) / (capped * 3.0), torch.zeros_like(capped))
    parts = {"classification": focal.mean(), "regression": box.mean(), "rotation": rotation.mean(),
             "translation": translation.mean(), "hand": hand.mean()}
    parts = {k: v * LOSS_WEIGHTS[k] for k, v in parts.items()}
    parts["total"] = sum(parts.values())
    return parts


def augmented_batch(data: Dict[str, torch.Tensor], idx: Sequence[int], draws, image_size: int,
                    hand_relative: bool = False):
    """The step's batch worked out from the raw frames and the draws:
    (images NHWC, cameras (B, 6), boxes, transformation (B, 8), coords (B, 63))."""
    b = len(idx)
    frames, boxes, rots, trans, coords = [], [], [], [], []
    noise_seen = [0, 0]
    for row, i in enumerate(idx):
        img = data["frames"][i].float()
        box, rot, t, c = data["boxes"][i], data["rotvecs"][i], data["translations"][i], data["hands"][i]
        applied = bool(draws["apply"][row])
        ops, noise = [], []
        for slot in range(augment.MAX_SLOTS):
            op = int(draws["op_ids"][row, slot]) if applied and slot < int(draws["n_slots"][row]) else augment.IDENTITY
            ops.append(op)
            if op == augment.GAUSSIAN_NOISE:
                noise.append(draws["noise"][slot][noise_seen[slot]])
                noise_seen[slot] += 1
            else:
                noise.append(None)
        img = augment.colour_row(img, ops, draws["magnitudes"][row], draws["factors"][row], draws["cutout_yx"][row],
                                 noise).to(torch.uint8)
        if applied:
            cam = data["cameras"][i]
            img, box, rot, t, c = augment.warp_6dof(img, data["masks"][i], box, rot, t, c, cam[0, 2], cam[1, 2],
                                                    draws["angles"][row].float(), draws["scales"][row].float())
        frames.append(img)
        boxes.append(box)
        rots.append(rot)
        trans.append(t)
        coords.append(c)
    h, w = frames[0].shape[:2]
    scale = image_size / max(h, w)
    images = preprocess(torch.stack(frames), image_size)
    cams = torch.stack([torch.stack([data["cameras"][i][0, 0], data["cameras"][i][1, 1], data["cameras"][i][0, 2],
                                     data["cameras"][i][1, 2]]) for i in idx]).float()
    cams = torch.cat([cams, torch.full((b, 1), 1000.0, device=cams.device),
                      torch.full((b, 1), scale, device=cams.device)], dim=1)
    rots, trans = torch.stack(rots).float(), torch.stack(trans).float()
    transformation = torch.cat([rots / math.pi, trans, torch.zeros((b, 2), device=rots.device)], dim=1)
    hand = torch.stack(coords).float() * scale
    if hand_relative:
        hand = hand - (trans / 1000.0)[:, None, :]
    return images, cams, torch.stack(boxes).float() * scale, transformation, hand.reshape(b, 63)


def follow(widths: Widths, P0: Dict[str, torch.Tensor], data: Dict[str, torch.Tensor], steps: List[Dict],
           image_size: int, lr: float = 1e-4, hand_relative: bool = False, tf32: bool = False,
           half: bool = False) -> Dict:
    """The reference's run of ``steps`` (each: ``idx``, ``draws``, ``drop``)
    from the weights ``P0`` of the network of ``widths``; returns per-step losses, the first gradient
    and the change of every trained leaf.  ``tf32``: the control, the
    reference in TF32; ``half``: a fault, each step's loss over the first
    half of its batch."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        device = next(iter(P0.values())).device
        P = {k: v.detach().clone() for k, v in P0.items()}
        trained = [k for k in P if not k.startswith("backbone/")]
        m = {k: torch.zeros_like(P[k]) for k in trained}
        v = {k: torch.zeros_like(P[k]) for k in trained}
        anchor_boxes, trans_anchors = (torch.as_tensor(a, device=device) for a in anchors(image_size))
        points = data["points"][::max(data["points"].shape[0] // 500 - 1, 1)][:500].float()
        out_losses, first_grad = [], None
        for t, step in enumerate(steps, start=1):
            images, cams, boxes, transformation, hand = augmented_batch(data, step["idx"], step["draws"], image_size,
                                                                          hand_relative)
            drop = step["drop"]
            if half:
                n = images.shape[0] // 2
                images, cams, boxes, transformation, hand, drop = (images[:n], cams[:n], boxes[:n], transformation[:n],
                                                                   hand[:n], drop[:, :n])
            for k in trained:
                P[k].requires_grad_(True)
            out = Net(widths, P, training=True).forward(images, drop)
            raw = out["translation_raw"]
            stride = trans_anchors[:, 2]
            x = (trans_anchors[:, 0] + raw[..., 0] * stride) / cams[:, 5:6] - cams[:, 2:3]
            y = (trans_anchors[:, 1] + raw[..., 1] * stride) / cams[:, 5:6] - cams[:, 3:4]
            tz = raw[..., 2] * cams[:, 4:5]
            translation_mm = torch.stack([x * tz / cams[:, 0:1], y * tz / cams[:, 1:2], tz], dim=-1)
            with torch.no_grad():
                tg = targets(anchor_boxes, boxes, transformation, hand, image_size)
            parts = losses(out, translation_mm, tg, points)
            grads = torch.autograd.grad(parts["total"], [P[k] for k in trained])
            out_losses.append([float(parts[k].detach()) for k in ("total", "classification", "regression", "rotation",
                                                          "translation", "hand")])
            with torch.no_grad():
                b1, b2, eps = ADAM
                for k, g in zip(trained, grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = m[k] / (1 - b1 ** t)
                    vhat = v[k] / (1 - b2 ** t)
                    P[k] = (P[k] - lr * mhat / (vhat.sqrt() + eps)).detach()
                if first_grad is None:
                    first_grad = {k: float(g.norm()) for k, g in zip(trained, grads)}
        change = {k: float((P[k] - P0[k]).norm()) for k in trained}
        return {"losses": out_losses, "grad": first_grad, "change": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep: Sequence[str]) -> float:
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers ``correct`` holds (module docstring)."""
    loss_gap = 0.0
    for p_row, r_row in zip(prog["losses"], ref["losses"]):
        for p, r in zip(p_row, r_row):
            loss_gap = max(loss_gap, abs(p - r) / max(abs(r), 1e-12))
    med = float(np.median(list(ref["grad"].values())))
    keep = [k for k, g in ref["grad"].items() if g >= 1e-3 * med]
    return {"loss_gap": loss_gap, "grad_gap": _leaf_gap(prog["grad"], ref["grad"], keep),
            "change_gap": _leaf_gap(prog["change"], ref["change"], keep)}
