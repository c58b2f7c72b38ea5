"""Write the JAX package's references for the ``cli_rest`` phase of ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python scripts/make_cli_reference.py [--work-dir DIR] [--skip-port]

Everything runs in the JAX package on the CPU, on the 1000-frame, 256 px,
seed-0, hand-render-v3 synthetic set (generated with its ``make-synthetic``;
the set ``chip_smoke.py`` regenerates with the port's), and goes to
``hmd_ego_pose_tpu_torch/eval/references/cli_rest.json``:

1. **The iter-1 checkpoint.**  The fp32 leaves of
   ``trained/syn1000_phi0_576ep_handrel_int8.npz`` plus the iterative
   subnets' leaves of an ``iter_steps=1`` model, drawn by ``add_iter_leaves``
   (the same function as ``chip_smoke.py``'s), saved with the int8 backend.
2. **``cli evaluate --iter 1``** of it on the fold-0 val partition (200
   frames, fp32, score threshold 0.5): the scalars, beside those at iter 0
   (``handrel_v3_val.json``) to show that the refinement moves the poses and
   keeps the detections.
3. **Four training steps at ``--iter 1``** from it, as
   ``scripts/make_train_reference.py`` makes them (batch 16, Adam 1e-4,
   frozen backbone, augmentation and drop-connect off, batch s = train
   frames 16 s .. 16 s + 15), with the port's CPU steps and the tolerance
   rule of that script unless ``--skip-port``.
4. **``cli format-labels``** of ``chip_smoke.label_pickles`` (8 seeded
   256 px frames, one corrupt) and **``cli debug``** of the result (with the
   generated set's ``models/``): the digests of ``chip_smoke.tree_digests``.
5. **``cli parity``** of the artifact's weights as a reference-named torch
   state_dict with a ``module.`` prefix (``export_torch_state_dict``,
   ``torch.save``) on the seeded input: the printed lines, and each layer's
   mean / std / absmax and each head's first six values at full precision.

Takes about five minutes on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
OUT = os.path.join(REPO, "hmd_ego_pose_tpu_torch", "eval", "references", "cli_rest.json")
ITER0 = os.path.join(REPO, "hmd_ego_pose_tpu_torch", "eval", "references", "handrel_v3_val.json")
ARTIFACT = os.path.join(REPO, "trained", "syn1000_phi0_576ep_handrel_int8.npz")
GENERATE = ["make-synthetic", "--num-frames", "1000", "--frame-size", "256", "--hand-render-version", "3"]
ITER_SEED, ITER_SCALE = 13, 0.01


def add_iter_leaves(flat: dict, template: dict) -> dict:
    """The flat checkpoint leaves ``flat`` ("params/..." and "bn/..." keys)
    and, for every key of ``template`` that they lack (the iterative
    subnets'), a float32 leaf drawn in sorted key order from
    ``RandomState(ITER_SEED)``: BN variances 1, means 0, scales
    1 + ITER_SCALE u, every other leaf ITER_SCALE u, u uniform in [-1, 1)."""
    rng = np.random.RandomState(ITER_SEED)
    out = dict(flat)
    for key in sorted(set(template) - set(flat)):
        shape, leaf = np.shape(template[key]), key.rsplit("/", 1)[1]
        if leaf == "var":
            value = np.ones(shape)
        elif leaf == "mean":
            value = np.zeros(shape)
        else:
            value = (1.0 if leaf == "scale" else 0.0) + ITER_SCALE * rng.uniform(-1.0, 1.0, size=shape)
        out[key] = value.astype(np.float32)
    return out


def jax_cli(argv) -> str:
    """The JAX package's CLI in this process; returns what it printed."""
    from hmd_ego_pose_tpu import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


def iter1_checkpoint(directory: str) -> str:
    """Step 1: the int8 iter-1 checkpoint; returns its path."""
    from hmd_ego_pose_tpu.config import ModelConfig
    from hmd_ego_pose_tpu.models import hmd_ego_pose
    from hmd_ego_pose_tpu.train.checkpoint import _flatten, _unflatten, restore_checkpoint, save_checkpoint

    params, bn_state, meta = restore_checkpoint(ARTIFACT)
    flat = {**{"params/" + k: np.asarray(v) for k, v in _flatten(params).items()},
            **{"bn/" + k: np.asarray(v) for k, v in _flatten(bn_state).items()}}
    tp, tb = hmd_ego_pose.init_host(0, ModelConfig(phi=0, image_size=256, iter_steps=1))
    template = {**{"params/" + k: v for k, v in _flatten(tp).items()},
                **{"bn/" + k: v for k, v in _flatten(tb).items()}}
    full = add_iter_leaves(flat, template)
    params = _unflatten({k[len("params/"):]: v for k, v in full.items() if k.startswith("params/")})
    bn_state = _unflatten({k[len("bn/"):]: v for k, v in full.items() if k.startswith("bn/")})
    return save_checkpoint(directory, "iter1_int8", params, bn_state,
                           metadata={"hand_relative": meta["hand_relative"]}, backend="int8")


def parity(directory: str) -> dict:
    """Step 5: ``cli parity`` of the artifact as a ``module.``-prefixed torch state_dict."""
    import jax.numpy as jnp
    import torch

    from hmd_ego_pose_tpu.config import ModelConfig
    from hmd_ego_pose_tpu.models import hmd_ego_pose
    from hmd_ego_pose_tpu.models.weights import convert_torch_state_dict, export_torch_state_dict
    from hmd_ego_pose_tpu.train.checkpoint import restore_checkpoint

    cfg = ModelConfig(phi=0, image_size=256)
    params, bn_state, _ = restore_checkpoint(ARTIFACT)
    sd = {"module." + k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_torch_state_dict(params, bn_state, cfg).items()}
    path = os.path.join(directory, "artifact_state_dict.pth")
    torch.save(sd, path)
    printed = jax_cli(["parity", "--torch-ckpt", path])

    # cmd_parity's own computation, kept at full precision
    template = hmd_ego_pose.init_host(0, cfg)
    p, b, report = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()}, *template, cfg)
    x = np.random.RandomState(0).uniform(-1, 1, size=(1, 256, 256, 3)).astype(np.float32)
    capture = {}
    out, _ = hmd_ego_pose.apply(p, b, jnp.asarray(x), cfg, capture=capture)
    stats = {}
    for name in sorted(capture):
        a = np.asarray(capture[name])
        stats[name] = [float(a.mean()), float(a.std()), float(np.abs(a).max())]
    heads = {f: [float(v) for v in np.asarray(getattr(out, f))[0, 0, :6]]
             for f in ("regression", "classification", "rotation", "translation_raw", "hand")}
    return {"printed": printed, "stats": stats, "heads": heads,
            "report": {"missing": len(report["missing"]), "unused": len(report["unused"])},
            "state_dict": "export_torch_state_dict of the artifact's fp32 leaves, keys prefixed 'module.', "
                          "tensors, torch.save", "input": "RandomState(0).uniform(-1, 1, (1, 256, 256, 3)) float32"}


def format_labels(directory: str, models_dir: str) -> dict:
    """Step 4: ``cli format-labels`` of the seeded pickles, then ``cli debug`` of its train split."""
    from chip_smoke import label_pickles, tree_digests

    pickles = os.path.join(directory, "pickles")
    os.makedirs(pickles)
    label_pickles(pickles)
    out = os.path.join(directory, "labels")
    jax_cli(["format-labels", "--in-dir", pickles, "--out-dir", out])
    digests = tree_digests(out)
    shutil.copytree(models_dir, os.path.join(out, "models"))
    viz = os.path.join(directory, "debug")
    jax_cli(["debug", "--dataset-path", out, "--out-dir", viz, "--num-images", "8"])
    return {"format_labels_digests": digests, "debug_digests": tree_digests(viz)}


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from chip_smoke import npz_digest
    from make_train_reference import TERMS, TOLERANCE_RULE, jax_losses, port_losses

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--work-dir", default=None, help="where the set is generated (default: a temp dir)")
    parser.add_argument("--skip-port", action="store_true", help="do not run the port's CPU training steps")
    args = parser.parse_args()
    with open(ITER0) as f:
        iter0 = json.load(f)["scalars"]
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(args.work_dir or tmp, "syn1000_v3_256")
        if not os.path.isdir(data):
            jax_cli([*GENERATE, "--out-dir", data])
        with open(os.path.join(data, "data", "01", "gt_0.yml"), "rb") as f:
            gt_hash = hashlib.sha256(f.read()).hexdigest()
        ckpt = iter1_checkpoint(tmp)
        ckpt_hash = npz_digest(ckpt)
        printed = jax_cli(["evaluate", "--dataset-path", data, "--ckpt", ckpt, "--partition", "val", "--iter", "1"])
        scalars = json.loads(printed[printed.rindex("\n{") + 1:])
        if scalars["num_matched"] != iter0["num_matched"]:
            raise AssertionError(f"the refinement changed the detections: {scalars['num_matched']} "
                                 f"matched at iter 1, {iter0['num_matched']} at iter 0")
        steps, _ = jax_losses(data, 1, ckpt, iter_steps=1)
        port = None if args.skip_port else port_losses(data, 1, ckpt, iter_steps=1)
        labels = format_labels(tmp, os.path.join(data, "models"))
        parity_record = parity(tmp)
    gaps = None if port is None else [
        max(abs(p[t] - r[t]) / max(abs(r[t]), 1e-12) for t in TERMS) for p, r in zip(port, steps)]
    tolerance = {s: max(floor, TOLERANCE_RULE["factor_over_cpu_gap"] * (0.0 if gaps is None else gaps[int(s)]))
                 for s, floor in TOLERANCE_RULE["floor_rel"].items()}
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True,
                            text=True).stdout.strip() or None
    record = {
        "iter1_checkpoint": {"seed": ITER_SEED, "scale": ITER_SCALE, "npz_digest": ckpt_hash,
                             "rule": "artifact leaves + add_iter_leaves(template of init_host(0, iter_steps=1)), "
                                     "saved with the int8 backend"},
        "evaluate": {"scalars": scalars, "minus_iter0": {k: scalars[k] - iter0[k] for k in scalars},
                     "command": "cli evaluate --dataset-path D --ckpt iter1_int8.npz --partition val --iter 1"},
        "train": {"steps": steps, "port_cpu_steps": port, "port_cpu_max_rel_gap": gaps,
                  "tolerance_rel": tolerance, "tolerance_rule": TOLERANCE_RULE,
                  "batch_indices": "step s: train-split frames 16*s .. 16*s+15 (fold 0, sorted frame names)"},
        **labels,
        "parity": parity_record,
        "gt_0_yml_sha256": gt_hash,
        "generate": "python -m hmd_ego_pose_tpu.cli " + " ".join(GENERATE) + " --out-dir D",
        "command": "JAX_PLATFORMS=cpu python scripts/make_cli_reference.py",
        "commit": commit,
        "numpy": np.__version__,
    }
    with open(OUT, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({k: v for k, v in record.items() if k not in ("format_labels_digests", "debug_digests")},
                     indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
