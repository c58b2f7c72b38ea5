"""Write the JAX package's export of the shipped artifact, the reference of the card's export.

    JAX_PLATFORMS=cpu python scripts/make_export_reference.py

Runs the JAX package's ``cli export --ckpt trained/syn1000_phi0_576ep_handrel_int8.npz
--quantize-int8`` (phi-0, 256 px, float32) on the CPU into a temporary
directory, then the port's ``cli export --device cpu`` of the same artifact,
and writes ``hmd_ego_pose_tpu_torch/export/references/handrel_export.json``:
the sha256 of the seeded input, the text of the meta JSON, a summary of each
golden output (``hmd_ego_pose_tpu_torch/export/reference.py::summarize``),
the canonical content digests of ``weights_fp32.npz`` and
``weights_int8.npz``, and the tolerance of the goldens: per output, ten times
the port's CPU gap to the JAX goldens, and never below 1e-4 relative.  The
port's weight files must have the JAX files' digests, or the script fails.

``chip_smoke.py`` holds the port's export on the card to this file.  Runs on
the CPU in about two minutes.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from hmd_ego_pose_tpu_torch import cli  # noqa: E402
from hmd_ego_pose_tpu_torch.export import reference  # noqa: E402

ARTIFACT = "trained/syn1000_phi0_576ep_handrel_int8.npz"
EXPORT = ["export", "--ckpt", ARTIFACT, "--quantize-int8"]
NAME = "hmd_ego_pose"
FLOOR_REL = 1e-4


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def goldens(out_dir: str) -> dict:
    with np.load(os.path.join(out_dir, f"{NAME}_golden.npz")) as data:
        return {k: data[k] for k in data.files}


def main() -> None:
    import torch

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        jax_dir, port_dir = os.path.join(tmp, "jax"), os.path.join(tmp, "port")
        jax_out = subprocess.run([sys.executable, "-m", "hmd_ego_pose_tpu.cli", *EXPORT, "--out-dir", jax_dir],
                                 cwd=REPO, env=env, capture_output=True, text=True, check=True).stdout
        with contextlib.redirect_stdout(io.StringIO()) as port_out:
            cli.main([*EXPORT, "--out-dir", port_dir, "--device", "cpu"])

        want = goldens(jax_dir)
        anchors = reference.sample_anchors(want["classification"])
        outputs = reference.summarize(want, anchors)
        with open(os.path.join(jax_dir, f"{NAME}_meta.json")) as f:
            meta_text = f.read()
        digests = {n: reference.content_digest(os.path.join(jax_dir, f"{n}.npz"))
                   for n in ("weights_fp32", "weights_int8")}
        port_digests = {n: reference.content_digest(os.path.join(port_dir, f"{n}.npz")) for n in digests}
        if port_digests != digests:
            raise SystemExit(f"the port's weight files differ from the JAX package's: {port_digests} vs {digests}")
        if sha256(os.path.join(port_dir, f"{NAME}_input.npy")) != sha256(os.path.join(jax_dir, f"{NAME}_input.npy")):
            raise SystemExit("the port's seeded input differs from the JAX package's")
        port_gaps = reference.gaps(goldens(port_dir), outputs, anchors)
        input_sha = sha256(os.path.join(jax_dir, f"{NAME}_input.npy"))

    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True,
                            text=True).stdout.strip() or None
    record = {
        "command": "JAX_PLATFORMS=cpu python -m hmd_ego_pose_tpu.cli " + " ".join(EXPORT) + " --out-dir D",
        "jax_printed": jax_out.replace(jax_dir, "D").strip().splitlines(),
        "port_printed": port_out.getvalue().replace(port_dir, "D").strip().splitlines(),
        "commit": commit,
        "numpy": np.__version__,
        "torch": torch.__version__,
        "input_sha256": input_sha,
        "meta_json": meta_text,
        "anchors": anchors,
        "outputs": outputs,
        "weights_digest": digests,
        "port_cpu_gap_rel": port_gaps,
        "tolerance_rel": {k: max(10 * g, FLOOR_REL) for k, g in port_gaps.items()},
        "tolerance_rule": "per output: 10 x the port's CPU gap to the JAX goldens, at least 1e-4; "
                          "values, min and max over the output's max |x|, sums over its sum |x|",
    }
    os.makedirs(os.path.dirname(reference.REFERENCE), exist_ok=True)
    with open(reference.REFERENCE, "w") as f:
        json.dump(record, f, indent=0, sort_keys=True)
        f.write("\n")
    print(json.dumps({k: record[k] for k in ("input_sha256", "weights_digest", "port_cpu_gap_rel",
                                             "tolerance_rel", "jax_printed", "port_printed")}, indent=1))


if __name__ == "__main__":
    main()
