"""Write the JAX package's evaluation of the shipped artifact on the v3 val set.

    JAX_PLATFORMS=cpu python scripts/make_eval_reference.py [--work-dir DIR]

Generates the 1000-frame, 256 px, seed-0, hand-render-v3 synthetic set with
the JAX package's ``make-synthetic``, runs the JAX package's ``cli evaluate``
on its fold-0 val partition (200 frames) with
``trained/syn1000_phi0_576ep_handrel_int8.npz`` (fp32 forward, the CLI's
default, score threshold 0.5), and writes the scalars, the command, the
commit, the numpy version and the sha256 of the generated ``gt_0.yml`` to
``hmd_ego_pose_tpu_torch/eval/references/handrel_v3_val.json``.

``chip_smoke.py`` regenerates the same set with the port's generator on the
card, checks the ``gt_0.yml`` hash, and holds the port's evaluation to these
scalars.  Runs on the CPU in about two minutes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "hmd_ego_pose_tpu_torch", "eval", "references", "handrel_v3_val.json")
ARTIFACT = "trained/syn1000_phi0_576ep_handrel_int8.npz"
GENERATE = ["make-synthetic", "--num-frames", "1000", "--frame-size", "256",
            "--hand-render-version", "3"]
EVALUATE = ["evaluate", "--ckpt", ARTIFACT, "--partition", "val"]


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def run_cli(args, env) -> str:
    cmd = [sys.executable, "-m", "hmd_ego_pose_tpu.cli", *args]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, check=True)
    return out.stdout


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--work-dir", default=None, help="where the set is generated (default: a temp dir)")
    args = parser.parse_args()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(args.work_dir or tmp, "syn1000_v3_256")
        run_cli([*GENERATE, "--out-dir", data], env)
        stdout = run_cli([*EVALUATE, "--dataset-path", data], env)
        gt_hash = sha256(os.path.join(data, "data", "01", "gt_0.yml"))
    # the CLI prints the 17-line report, then the scalars as indented JSON
    scalars = json.loads(stdout[stdout.rindex("\n{") + 1:])
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True,
                            text=True).stdout.strip() or None
    record = {
        "scalars": scalars,
        "generate": "python -m hmd_ego_pose_tpu.cli " + " ".join(GENERATE) + " --out-dir D",
        "command": "JAX_PLATFORMS=cpu python -m hmd_ego_pose_tpu.cli " + " ".join(EVALUATE)
                   + " --dataset-path D",
        "commit": commit,
        "numpy": np.__version__,
        "gt_0_yml_sha256": gt_hash,
        "frames": {"generated": 1000, "evaluated": "fold 0, val partition"},
        "forward": "float32, unfolded, score threshold 0.5 (ModelConfig / cli defaults)",
    }
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(record, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
