"""Judge served poses against the plain reference.

For each frame in the sample, the reference decodes the frame the client
sent (I420), preprocesses it, runs the float32 network and decodes every
anchor's score, rotation and translation.  The served pose is the pose of
the anchor the program scored best.  Many anchors score within rounding of
1 on a frame, each with a pose of its own (a bfloat16 sigmoid is exactly 1
above a logit of about 6, and the first such anchor wins), so which of
them is best is rounding's choice.  The answer is held to the reference's
candidates, the anchors it scores within ``SCORE_SLACK`` of its best, as a
served token is held to the reference's logits:

* a served pose is matched to the candidate it lies nearest to:
  ``pose_gap_mm``, the translation's distance in mm plus the rotation's
  (the largest of its three components) in units of 0.01 rad;
  ``rotation_gap_rad`` and ``translation_gap_mm`` are the two parts at the
  matched candidate;
* ``detection_gap``: an empty answer (no detection) reads how far the
  reference's best lies above the 0.5 threshold, a pose how far its
  matched candidate lies below it; an empty answer where the reference's
  best clears the threshold by more than ``SCORE_SLACK`` reads every pose
  gap as infinite.
* ``detection_misses``: the frames whose detection the two computations
  disagree on beyond ``SCORE_SLACK``: an empty answer where the reference
  detects, or a pose where the reference's best lies below the threshold.

These are gaps between two computations of one answer: exact agreement
reads 0, rounding reads small, a wrong, altered or dropped answer reads
large.  ``judge`` gives each gap's widest over the sample, and as
``<gap>.median`` and ``<gap>.p90`` its median and 90th percentile (the
``ceil(0.9 (n - 1))``-th smallest): a frame whose near-best anchors
disagree about the pose makes the widest swing from seed to seed
(PERF.md), while one wrong answer in ten moves the 90th percentile.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reference.model import Net, Widths, anchors, decode_poses, i420_to_rgb, preprocess

TOP = 256
SCORE_SLACK = 0.01
ROTATION_UNIT = 0.01  # rad weighed as one mm when matching
THRESHOLD = 0.5
NUMBERS = ("detection_gap", "pose_gap_mm", "rotation_gap_rad", "translation_gap_mm")


def candidates(widths: Widths, P, S, payloads: Sequence[bytes], height: int, width: int, camera: np.ndarray,
               size: int, device, fp8: bool = False, block: int = 16) -> List[Dict[str, np.ndarray]]:
    """The reference's ``TOP`` candidates of each frame from the network of
    ``widths``: score, rotation (rad), translation (m), best first; in
    blocks of ``block`` frames."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = Net(widths, {k: torch.as_tensor(v, device=device) for k, v in P.items()},
              {k: torch.as_tensor(v, device=device) for k, v in S.items()}, fp8=fp8)
    trans_anchors = torch.as_tensor(anchors(size)[1], device=device)
    out = []
    with torch.no_grad():
        for lo in range(0, len(payloads), block):
            chunk = payloads[lo:lo + block]
            frames = torch.as_tensor(np.stack([i420_to_rgb(p, height, width) for p in chunk]), device=device)
            cams = torch.as_tensor(np.tile(camera[None].astype(np.float32), (len(chunk), 1)), device=device)
            scores, rot, trans = decode_poses(net.forward(preprocess(frames, size)), trans_anchors, cams)
            top = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :TOP]
            for i in range(len(chunk)):
                idx = top[i]
                out.append({"score": scores[i, idx].cpu().numpy().astype(np.float64),
                            "rotation": rot[i, idx].cpu().numpy().astype(np.float64),
                            "translation": trans[i, idx].cpu().numpy().astype(np.float64)})
    return out


def answer_of(cand: Dict[str, np.ndarray]) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """What a server computing like the candidates would answer: the best
    anchor's pose where its score clears the threshold, else nothing."""
    if cand["score"][0] > THRESHOLD:
        return cand["rotation"][0], cand["translation"][0]
    return None


def gaps(answer: Optional[Tuple[np.ndarray, np.ndarray]], cand: Dict[str, np.ndarray]) -> Dict[str, float]:
    best = cand["score"][0]
    if answer is None:
        missed = best > THRESHOLD + SCORE_SLACK
        pose = float("inf") if missed else 0.0
        return {"detection_gap": max(0.0, best - THRESHOLD), "pose_gap_mm": pose, "translation_gap_mm": pose,
                "rotation_gap_rad": pose, "missed": float(missed)}
    rotation, translation = (np.asarray(a, np.float64) for a in answer)
    if not (np.all(np.isfinite(rotation)) and np.all(np.isfinite(translation))):
        return dict({k: float("inf") for k in NUMBERS}, missed=1.0)
    near = cand["score"] >= best - SCORE_SLACK
    d = np.linalg.norm(cand["translation"][near] - translation[None], axis=1) * 1000.0
    r = np.abs(cand["rotation"][near] - rotation[None]).max(axis=1)
    cost = d + r / ROTATION_UNIT
    j = int(np.argmin(cost))
    return {"detection_gap": max(THRESHOLD - float(cand["score"][near][j]), 0.0), "pose_gap_mm": float(cost[j]),
            "translation_gap_mm": float(d[j]), "rotation_gap_rad": float(r[j]),
            "missed": float(best < THRESHOLD - SCORE_SLACK)}


def _p90(values: List[float]) -> float:
    return sorted(values)[int(np.ceil(0.9 * (len(values) - 1)))] if values else 0.0


def judge(answers: Sequence, cands: Sequence[Dict[str, np.ndarray]]) -> Dict[str, float]:
    """Each gap over the sample: its widest, its median as ``<gap>.median``
    and its 90th percentile as ``<gap>.p90``; and ``detection_misses``."""
    per = [gaps(a, c) for a, c in zip(answers, cands)]
    out: Dict[str, float] = {}
    for k in NUMBERS:
        values = [g[k] for g in per]
        out[k] = max(values, default=0.0)
        out[k + ".median"] = float(np.median(values)) if values else 0.0
        out[k + ".p90"] = _p90(values)
    out["detection_misses"] = float(sum(g["missed"] for g in per))
    return out
