"""Readings that the limits of ``correct`` are set from, on the card.

    python benchmark/tools/readings.py sweep --workload W --counts 4,8,12 --seconds 8
    python benchmark/tools/readings.py serve --workload W --seeds 1,2,3 --seconds 4

``sweep``: the headset counts in turn on one server (``harness/serve.py::sweep``).
``serve``: for each seed, a short window of the cell's traffic through one
server; the sample's gaps of the program's answers and of the control's
(the reference in float8, ``reference/model.py``) to the float32 reference.
One JSON line per seed or headset count on stdout (the sweep's on stderr
as it goes), and the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from harness import common, serve  # noqa: E402


def serve_readings(cell, seeds, seconds):
    import numpy as np
    import torch

    from harness.loadgen import rgb_to_i420
    from harness.synthetic import serving_frame
    from reference import serve_check
    from reference.model import Widths, load_artifact

    conf, traffic = cell["config"], cell["traffic"]
    device = torch.device("cuda")
    engine, server = serve.build_server(conf, traffic, device)
    P, S = load_artifact(os.path.join(common.ROOT, conf["serving"]["weights"]))
    widths, cam = Widths.of(conf), serve.camera(conf, traffic)
    h, w = traffic["frame_height"], traffic["frame_width"]
    rows = []
    try:
        for seed in seeds:
            gen = serve._LoadGen(serve.client_spec(traffic, seed))
            try:
                gen.receive()
                gen.send({"cmd": "run", "port": server.address[1], "start": time.monotonic() + 0.2,
                          "seconds": seconds, "grace": traffic["grace_seconds"], "salt": 1})
                frames = serve._window_frames(gen.receive())
            finally:
                gen.close()
            answered = [r for r in frames if r[3] is not None]
            rng = np.random.RandomState([seed % (2 ** 32), 0xC4EC])
            n = min(traffic["check_frames"], len(answered))
            sample = [answered[i] for i in sorted(rng.choice(len(answered), n, replace=False))]
            payloads = [rgb_to_i420(serving_frame(seed, r[0], h, w, traffic["focal_scale"])) for r in sample]
            ref = serve_check.candidates(widths, P, S, payloads, h, w, cam, conf["image_size"], device)
            ctl = serve_check.candidates(widths, P, S, payloads, h, w, cam, conf["image_size"], device, fp8=True)
            answers = [None if r[4] is None or None in r[4] else (np.array(r[4][:3]), np.array(r[4][3:]))
                       for r in sample]
            rows.append({"seed": seed, "frames": len(frames), "answered": len(answered), "sampled": n,
                         "detected": sum(a is not None for a in answers),
                         "program": serve_check.judge(answers, ref),
                         "control": serve_check.judge([serve_check.answer_of(c) for c in ctl], ref)})
            print(json.dumps(rows[-1]), flush=True)
    finally:
        server.stop()
    return rows


def train_readings(cell, seeds, seconds):
    """For each seed, a run of the cell (a short window) and its gaps; the
    control's: the reference in TF32 followed through the same steps, held to
    the reference in float32; and a fault's, planted in the reference put in
    the program's place: each step's loss over half of its batch."""
    from harness import train
    from reference import train_check

    rows = []
    for seed in seeds:
        out = train.run(cell, seed, seconds, False)
        r = out["replay"]
        ctl = train_check.follow(r["widths"], r["params"], r["data"], r["steps"], r["size"], lr=r["lr"],
                                 hand_relative=r["hand_relative"], tf32=True)
        half = train_check.follow(r["widths"], r["params"], r["data"], r["steps"], r["size"], lr=r["lr"],
                                  hand_relative=r["hand_relative"], half=True)
        rows.append({"seed": seed, "program": out["gaps"], "control": train_check.compare(ctl, r["reference"]),
                     "fault_half": train_check.compare(half, r["reference"]),
                     "images_per_s": out["e2e"]["train_images_per_s"], "setup_s": out["e2e"]["setup_s"]})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("what", choices=("sweep", "serve", "train"))
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="1")
    parser.add_argument("--counts", default="")
    parser.add_argument("--seconds", type=int, default=4)
    parser.add_argument("--clients", type=int, default=0, help="headsets in place of the traffic's")
    args = parser.parse_args()
    common.set_cache_dirs()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = common.cell(args.workload)
    if args.clients:
        cell["traffic"]["clients"] = args.clients
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if args.what == "sweep":
        rows = serve.sweep(cell, [int(c) for c in args.counts.split(",")], seeds[0], args.seconds)
    elif args.what == "train":
        rows = train_readings(cell, seeds, args.seconds)
    else:
        rows = serve_readings(cell, seeds, args.seconds)
    print(json.dumps({"card": common.power_limit(), "rows": len(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
