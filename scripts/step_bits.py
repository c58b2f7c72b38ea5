"""Whether the resident train step repeats its bits on the card: eager, through its CUDA graph, and across the two.

    python scripts/step_bits.py [--frames 120] [--steps 4]

Writes a ``--frames``-frame, 256 px, hand-render-v3 synthetic set into a
temporary directory, builds ``cli train``'s trainer of the shipped artifact
on it (phi-0, 256 px, fp32, batch 16) and runs ``--steps`` fixed steps
(augmentation and drop-connect off, frames 16 s .. 16 s + 15 of the train
split) from one state, four times: eagerly twice and through a
``train/step.py::ResidentGraph`` twice (one capture, then replays only),
first with cuDNN's default algorithms and then with
``torch.backends.cudnn.deterministic``.  For each setting it compares eager
against eager, graph against graph and eager against graph: whether the
losses are bit-equal, the first step that differs, and how many tensors of
the model's state differ and by how much.  Then one backward of the first
batch twice from one state: the gradient leaves that differ.  Prints one
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--steps", type=int, default=4)
    opts = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as smoke
    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES, ResidentGraph

    if not torch.cuda.is_available():
        print("step_bits.py: no CUDA device is available", file=sys.stderr)
        return 2
    steps = opts.steps
    with tempfile.TemporaryDirectory(prefix="hegp_bits_") as work:
        data = os.path.join(work, "v3")
        args = cli.build_parser().parse_args(["train", "--dataset-path", data, "--ckpt", smoke.ARTIFACT, "--epo", "1"])
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["make-synthetic", "--out-dir", data, "--num-frames", str(opts.frames), "--frame-size", "256",
                      "--hand-render-version", "3"])
            trainer = cli.build_trainer(args, checkpoint_dir=os.path.join(work, "ckpt"))
        start = {k: v.clone() for k, v in trainer.model.state_dict().items()}

        def state():
            torch.cuda.synchronize()
            return {k: v.clone() for k, v in trainer.model.state_dict().items()}

        def eager():
            smoke.restore_state(trainer, start)
            rows = []
            for s in range(steps):
                metrics = trainer.step_fn(trainer.data, smoke.fixed_batch(trainer, s), None, None)
                rows.append(torch.stack([metrics[k] for k in METRIC_NAMES]))
            return torch.stack(rows), state()

        def graphed(graph):
            smoke.restore_state(trainer, start)
            graph.reset()
            for s in range(steps):
                graph(smoke.fixed_batch(trainer, s), None, None)
            return graph.metrics.clone(), state()

        def compare(a, b):
            (la, sa), (lb, sb) = a, b
            first = next((s for s in range(steps) if not torch.equal(la[s], lb[s])), None)
            return {"losses_bit_equal": torch.equal(la, lb), "first_step_differing": first, **smoke.state_gap(sa, sb)}

        out = {}
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            try:
                e1, e2 = eager(), eager()
                graph = ResidentGraph(trainer.step_fn, trainer.data, steps)
                g1, g2 = graphed(graph), graphed(graph)
            finally:
                torch.backends.cudnn.deterministic = False
            out["deterministic" if deterministic else "default"] = {
                "eager_vs_eager": compare(e1, e2), "graph_vs_graph": compare(g1, g2),
                "eager_vs_graph": compare(e1, g1)}
            del graph

        def gradients():
            smoke.restore_state(trainer, start)
            bundle = trainer.step_fn.losses(trainer.step_fn.prepare(trainer.data, smoke.fixed_batch(trainer, 0), None))
            bundle.total.backward()
            grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters() if p.grad is not None}
            trainer.optimizer.zero_grad()
            return grads

        first, second = gradients(), gradients()
        differ = [n for n in first if not torch.equal(first[n], second[n])]
        out["backward_twice"] = {"leaves": len(first), "leaves_differing": len(differ), "differing": differ[:8]}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30).stdout.strip()
    print(json.dumps({"card": card, "frames": opts.frames, "steps": steps, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
