"""Device time of the port's frame preprocess (``ops/preprocess.py::preprocess_uint8_batch``) on the card.

    python scripts/time_preprocess.py [--root DIR] [--reps 50]

Imports ``hmd_ego_pose_tpu_torch`` from ``DIR`` (default: this checkout), so
two versions of the package can be timed in one run on one card: unpack the
other into an ignored directory with ``git archive`` and run this script on
each in turn.  Seeded uint8 frames of each shape are resized to 256 px and
normalized; the time is the mean of ``--reps`` back-to-back calls by CUDA
events after one warm-up call, so it includes any launch gaps of the host.
Prints one JSON line with the card's name and power limit, each shape's
time and the sha256 of its output bytes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

SHAPES = ((1, 300, 300), (1, 480, 480), (16, 480, 480), (1, 1080, 1920))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--size", type=int, default=256)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch.ops.preprocess import preprocess_uint8_batch

    if not torch.cuda.is_available():
        print("time_preprocess.py: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30, check=True).stdout.strip().splitlines()[0]
    rows = []
    for b, h, w in SHAPES:
        frames = np.random.default_rng(h * w + b).integers(0, 256, size=(b, h, w, 3), dtype=np.uint8)
        x = torch.from_numpy(frames).cuda()
        out = preprocess_uint8_batch(x, args.size)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            preprocess_uint8_batch(x, args.size)
        stop.record()
        stop.synchronize()
        rows.append({"shape": [b, h, w], "ms": start.elapsed_time(stop) / args.reps,
                     "sha256": hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]})
    print(json.dumps({"root": os.path.relpath(root), "card": card, "torch": torch.__version__,
                      "size": args.size, "reps": args.reps, "preprocess": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
