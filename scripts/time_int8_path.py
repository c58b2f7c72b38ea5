"""Host-clock time of the port's int8 restore and int8 save on the card.

    python scripts/time_int8_path.py [--root DIR] [--reps 10]

Imports ``hmd_ego_pose_tpu_torch`` from ``DIR`` (default: this checkout), so
two versions of the package can be timed in one run on one card: unpack the
other into an ignored directory with ``git archive`` and run this script on
each in turn (parent, change, change, parent).  Each rep, after one warm-up:

* ``restore``: ``restore_checkpoint`` of the shipped int8 artifact onto the
  card (file read, every int8 leaf dequantized, the rest uploaded);
* ``quantize_tree``: the int8 leaf rule over the restored params on the card
  (every large leaf quantized and copied back to the host);
* ``int8_save``: ``save_checkpoint(backend="int8")`` of the restored trees
  into a temporary directory (``quantize_tree`` and ``np.savez``).

Each is timed by the host clock with the card synchronised before and after.
Prints one JSON line: the card's name and power limit, the median and the
minimum of each time in ms, the kernel launches of one restore and of one
save, and digests of what they produced (the restored tensors' bytes, the
int8 file's canonical digest), which two versions must share.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--ckpt", default=os.path.join(HERE, "trained", "syn1000_phi0_576ep_handrel_int8.npz"))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from hmd_ego_pose_tpu_torch.export.reference import content_digest
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.ops.quantization import quantize_tree
    from hmd_ego_pose_tpu_torch.train.checkpoint import _flatten, restore_checkpoint, save_checkpoint

    if not torch.cuda.is_available():
        print("time_int8_path.py: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    def timed(fn):
        out = fn()  # warm-up: builds and loads the kernels
        torch.cuda.synchronize()
        ms = []
        for _ in range(args.reps):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return out, {"median_ms": statistics.median(ms), "min_ms": min(ms)}

    with tempfile.TemporaryDirectory(prefix="hegp_int8_") as work:
        LAUNCHES.reset()
        (params, bn_state, _), restore = timed(lambda: restore_checkpoint(args.ckpt, dev))
        restore_launches = {k: v // (args.reps + 1) for k, v in LAUNCHES.snapshot().items()}
        _, tree = timed(lambda: quantize_tree(params, dev))
        LAUNCHES.reset()
        path, save = timed(lambda: save_checkpoint(work, "w", params, bn_state, backend="int8", device=dev))
        save_launches = {k: v // (args.reps + 1) for k, v in LAUNCHES.snapshot().items()}
        restored = hashlib.sha256()
        for key, leaf in sorted(_flatten(params).items()):
            restored.update(key.encode() + leaf.cpu().numpy().tobytes())
        print(json.dumps({
            "root": os.path.relpath(root, HERE), "card": card, "torch": torch.__version__, "reps": args.reps,
            "restore": restore, "quantize_tree": tree, "int8_save": save,
            "launches_per_restore": restore_launches, "launches_per_save": save_launches,
            "restored_sha256": restored.hexdigest()[:16], "int8_file_digest": content_digest(path)[:16],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
