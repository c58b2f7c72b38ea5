"""Time the two colour passes of the port at the shapes its eager paths give them.

    python scripts/colour_pass_times.py [--device cuda|cpu] [--seeds 8] [--threads N]

``ops/augment_device.py`` has two passes that agree row for row:
``color_augment_batch`` (each slot grouped by op on the host, each op run
once on its rows; the eager paths run it) and ``color_augment_fixed``
(every op over the whole batch, a per-row select; the resident step's
graph runs it, since a replay cannot choose its kernels).  This script
measures which is faster where the kernels may change between steps.

For each case (batch, frame height, width): the eager and windowed steps
and the host pipeline's device augmentation on the 256 px v3 set (16), a
data-parallel rank of a two-rank mesh (8), ``make-synthetic``'s default
480 px frames (16), 480x640 frames (16) and the CPU tests' size (2 at
128 px).  For each of ``--seeds`` seeds it draws one batch's augmentation
(``draw_augment``, a host generator, as the trainer draws) and random
frames, and runs the passes in turns (grouped, fixed, fixed, grouped),
each timed on the host's clock from a synchronised start to a synchronised
end: what an eager step pays.  The fixed pass's time includes building its
``SlotDraws`` on the device (``slot_draws``), as an eager path would
have to.  Each call's result is held equal to the other pass's.  Prints the
card's name and power limit (on a card) and one JSON line: per case the
p50, min and max ms of each pass and the p50 ratio grouped / fixed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = (("eager_windowed_host_v3", 16, 256, 256), ("data_parallel_rank", 8, 256, 256),
         ("make_synthetic_480", 16, 480, 480), ("frame_480x640", 16, 480, 640), ("cpu_tests", 2, 128, 128))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--threads", type=int, default=None, help="torch's CPU threads (default: torch's own)")
    opts = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    from hmd_ego_pose_tpu_torch.ops import augment_device as aug

    dev = torch.device(opts.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("colour_pass_times.py: no CUDA device is available", file=sys.stderr)
        return 2
    if opts.threads:
        torch.set_num_threads(opts.threads)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return (time.perf_counter() - t0) * 1e3, out

    passes = {
        "grouped": lambda x, d: aug.color_augment_batch(x, d),
        "fixed": lambda x, d: aug.color_augment_fixed(x, aug.slot_draws(d, x.shape[1], x.shape[2], x.device)),
    }
    result = {"device": str(dev), "threads": torch.get_num_threads(), "seeds": opts.seeds, "cases": {}}
    for name, b, h, w in CASES:
        ms = {k: [] for k in passes}
        for seed in range(opts.seeds):
            g = torch.Generator().manual_seed(seed)
            draws = aug.draw_augment(g, b, h, w)
            x = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, generator=g).to(dev)
            if seed == 0:
                for fn in passes.values():  # warm-up
                    fn(x, draws)
            outs = {}
            for k in ("grouped", "fixed", "fixed", "grouped"):
                t, outs[k] = timed(lambda k=k: passes[k](x, draws))
                ms[k].append(t)
            if not torch.equal(outs["grouped"], outs["fixed"]):
                raise AssertionError(f"{name}, seed {seed}: the two passes differ")
        row = {k: {"p50_ms": statistics.median(v), "min_ms": min(v), "max_ms": max(v)} for k, v in ms.items()}
        row.update(batch=b, height=h, width=w,
                   grouped_over_fixed_p50=row["grouped"]["p50_ms"] / row["fixed"]["p50_ms"])
        result["cases"][name] = row
    if cuda:
        result["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                        capture_output=True, text=True, timeout=30).stdout.strip()
        print(result["card"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
