"""Launch times of design variants of the min-distance and target-assignment kernels, beside the committed ones.

    python scripts/time_kernel_variants.py [--reps 50] [--baseline DIR]

Each variant is a committed ``csrc/*.cu`` built with ``-D`` defines that
override its swept design constants (``VARIANTS``; the ``#ifndef`` defaults
in the source are the committed design), through ``kernels/build.py`` like
the port's own libraries, all builds in parallel.  At the shapes of the
port's paths (the evaluation's T=200, P=Q=600 and ten times its pairs for
min distances; the train step's 16 images, 12,276 anchors, one box, one
class for target assignment) every variant that computes the whole output
is first held bit-equal to the plain version, then each launch is timed
alone on the card (``chip_smoke.py``'s ``device_time_ms``: the calls queued
behind a spin kernel), in turns: committed, the variants, committed again.
With ``--baseline DIR`` (another checkout, unpacked with ``git archive``
into an ignored directory) that checkout's ``csrc/min_distances.cu``, whose
C interface is this one's, is built by that checkout's own
``kernels/build.py`` and timed in turns with the committed kernel:
baseline, committed, committed, baseline.  Prints the card's name and power
limit, the registers ptxas gives each build, then one JSON line per shape.
Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (source, -D defines, computes the whole output); a variant without
# defines is the committed kernel
VARIANTS = {
    "min_distances/committed": ("min_distances", (), True),
    "min_distances/2_points": ("min_distances", ("HEGP_MIN_DIST_POINTS=2",), True),
    "min_distances/8_points": ("min_distances", ("HEGP_MIN_DIST_POINTS=8",), True),
    "min_distances/2_warps": ("min_distances", ("HEGP_MIN_DIST_WARPS=2",), True),
    "min_distances/8_warps": ("min_distances", ("HEGP_MIN_DIST_WARPS=8",), True),
    "min_distances/unroll_4": ("min_distances", ("HEGP_MIN_DIST_UNROLL=4",), True),
    "min_distances/unroll_1": ("min_distances", ("HEGP_MIN_DIST_UNROLL=1",), True),
    "target_assign/committed": ("target_assign", (), True),
    "target_assign/best_anchor_only": ("target_assign", ("HEGP_TARGET_ASSIGN_LAUNCHES=1",), False),
    "target_assign/assign_only": ("target_assign", ("HEGP_TARGET_ASSIGN_LAUNCHES=2",), False),
    # launch bounds of one block per SM leave ptxas the registers it wants
    "target_assign/min_blocks_1": ("target_assign", ("HEGP_TARGET_ASSIGN_MIN_BLOCKS=1",), True),
}


def registers(build, source: str, defines: tuple) -> list:
    """ptxas's register lines of one build, from the log kept beside its library."""
    with open(build.library_path(source, defines)[:-3] + ".log") as f:
        return [line.split(":", 1)[1].strip() for line in f if "Used" in line]


def baseline_library(root: str):
    """``csrc/min_distances.cu`` of the checkout at ``root``, built by that checkout's ``kernels/build.py``."""
    path = os.path.join(os.path.abspath(root), "hmd_ego_pose_tpu_torch", "kernels", "build.py")
    spec = importlib.util.spec_from_file_location("hegp_baseline_build", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.library("min_distances")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--baseline", help="another checkout whose csrc/min_distances.cu is timed beside this one's")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_kernel_variants.py: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.kernels import build
    from hmd_ego_pose_tpu_torch.ops import distances
    from hmd_ego_pose_tpu_torch.ops.anchors import device_anchors
    from hmd_ego_pose_tpu_torch.ops.target_assign import (AnchorTargets, assign_targets_batch,
                                                          assign_targets_batch_reference)

    print(json.dumps({"card": chip_smoke.nvidia_smi(), "torch": torch.__version__}), flush=True)
    build.build_all(variants=[(source, defines) for source, defines, _ in VARIANTS.values()])
    libs = {name: build.library(source, defines) for name, (source, defines, _) in VARIANTS.items()}
    print(json.dumps({"registers": {name: registers(build, source, defines)
                                    for name, (source, defines, _) in VARIANTS.items()}}), flush=True)
    baseline = baseline_library(args.baseline) if args.baseline else None
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def timed(fn):
        return chip_smoke.device_time_ms(fn, reps=args.reps)

    rng = np.random.default_rng(5)
    for shape in ((200, 600, 600), (2000, 600, 600)):
        g, p = (torch.from_numpy(a).to(dev) for a in chip_smoke.point_pairs(rng, *shape))
        want = distances.min_distances_reference(g, p)
        out = torch.empty(shape[:2], device=dev)
        calls = {}
        for name, lib in ([("baseline", baseline)] if baseline else []) + list(libs.items()):
            if not name.startswith(("min_distances/", "baseline")):
                continue

            def call(lib=lib):
                return lib.hegp_min_distances(g.data_ptr(), p.data_ptr(), out.data_ptr(), *shape, stream)

            if call() != 0:
                raise RuntimeError(f"{name} does not launch")
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{name} differs from the plain version at {shape}")
            calls[name] = call
        row = {"kernel": "min_distances", "shape": list(shape)}
        if baseline:
            row["baseline"] = timed(calls.pop("baseline"))
        row["committed"] = timed(lambda: distances.min_distances(g, p))
        row.update((name, timed(call)) for name, call in calls.items())
        row["committed_again"] = timed(lambda: distances.min_distances(g, p))
        if baseline:
            row["baseline_again"] = timed(lambda: baseline.hegp_min_distances(
                g.data_ptr(), p.data_ptr(), out.data_ptr(), *shape, stream))
        print(json.dumps(row), flush=True)

    cfg = ModelConfig()
    anchors = device_anchors(cfg.image_size, cfg.anchors, dev)[0]
    gt = [torch.from_numpy(x).to(dev) for x in chip_smoke.target_batch(np.random.default_rng(3), 16, 1, 1)]
    kw = dict(num_classes=1, image_size=cfg.image_size)
    want = assign_targets_batch_reference(anchors, *gt, **kw)
    out = AnchorTargets(*(torch.empty_like(x) for x in want))
    best = torch.empty(gt[1].shape, dtype=torch.int32, device=dev)
    b, k = gt[1].shape
    row = {"kernel": "target_assign", "shape": [b, anchors.shape[0], k, 1],
           "committed": timed(lambda: assign_targets_batch(anchors, *gt, **kw))}
    for name, lib in libs.items():
        if not name.startswith("target_assign/"):
            continue

        def call(lib=lib):
            return lib.hegp_target_assign(*(x.data_ptr() for x in (anchors, *gt)), best.data_ptr(),
                                          *(x.data_ptr() for x in out), b, anchors.shape[0], k, 1,
                                          gt[2].shape[2], gt[3].shape[2], float(cfg.image_size), 0.5,
                                          float(np.float32(0.4)), stream)

        if call() != 0:
            raise RuntimeError(f"{name} does not launch")
        torch.cuda.synchronize()
        if VARIANTS[name][2] and not all(chip_smoke.same_bits(x, y) for x, y in zip(out, want)):
            raise AssertionError(f"{name} differs from the plain version")
        row[name] = timed(call)
    # the yardstick of the stores: torch's fill of the same five outputs (60.5 MB)
    row["fill_the_outputs"] = timed(lambda: [x.fill_(1.0) for x in out])
    row["committed_again"] = timed(lambda: assign_targets_batch(anchors, *gt, **kw))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
