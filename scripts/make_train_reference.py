"""Write the JAX package's training losses for the port's on-card training checks.

    JAX_PLATFORMS=cpu python scripts/make_train_reference.py [--set handrel_v3|multi2_v3] [--work-dir DIR] [--skip-port]

``--set handrel_v3`` (the default) generates the 1000-frame, 256 px, seed-0,
hand-render-v3 synthetic set with the JAX package's generator (the set
``chip_smoke.py`` regenerates with the port's) and starts from
``trained/syn1000_phi0_576ep_handrel_int8.npz`` (fp32 params after the int8
restore, ``hand_relative`` as its sidecar records).

``--set multi2_v3`` generates the 400-frame, 256 px, seed-0, hand-render-v3
set with two objects per frame (fold 0: 240 train, 80 val, 80 test frames)
and trains both objects (``--object-ids 1,2``: two classes, two ground-truth
rows per frame) from the same artifact, widened to two classes by
``hmd_ego_pose_tpu_torch/models/weights.py::widen_classes`` (the classifier
header's class column copied to both classes; the one rule the card's run
uses too).  Its record also holds the sha256 of the set's ``gt_0.yml``.

Either way four training steps of the JAX package run on the CPU: phi-0,
256 px, float32, batch 16, Adam 1e-4, frozen backbone, augmentation and
drop-connect off, batch s made of the train split's frames 16 s .. 16 s + 15.
Each step's six loss terms (the five weighted terms and their total, before
that step's update) go to
``hmd_ego_pose_tpu_torch/train/references/<set>_train_steps.json``.

Unless ``--skip-port``, the same four steps also run in the port on the CPU
(``cli.build_trainer``), and the file records the largest relative gap per
step: the gap between two float32 computations of the same arithmetic in
different summation orders.  The tolerance ``chip_smoke.py`` holds the card
to is set from it (see ``TOLERANCE_RULE``).  Takes a few minutes on the CPU.
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
sys.path.insert(0, REPO)
REFERENCES = os.path.join(REPO, "hmd_ego_pose_tpu_torch", "train", "references")
ARTIFACT = os.path.join(REPO, "trained", "syn1000_phi0_576ep_handrel_int8.npz")
BATCH, STEPS, IMAGE_SIZE, LR = 16, 4, 256, 1e-4
TERMS = ("total", "classification", "regression", "rotation", "translation", "hand")
# relative tolerance per loss term on the card: ten times the CPU gap between
# the two packages, and never below the floor (float32 sums of ~1e5 terms)
TOLERANCE_RULE = {"factor_over_cpu_gap": 10.0, "floor_rel": {"0": 1e-4, "3": 1e-4}}
# name -> (frames, objects): the generator's --num-frames and --num-objects
SETS = {"handrel_v3": (1000, 1), "multi2_v3": (400, 2)}


def step_indices(step: int) -> np.ndarray:
    return np.arange(BATCH * step, BATCH * (step + 1))


def generate_command(frames: int, objects: int) -> list:
    cmd = ["make-synthetic", "--num-frames", str(frames), "--frame-size", str(IMAGE_SIZE),
           "--hand-render-version", "3"]
    return cmd + (["--num-objects", str(objects)] if objects > 1 else [])


def jax_losses(data: str, objects: int, ckpt: str = ARTIFACT, iter_steps: int = 0):
    """The JAX package's four steps from ``ckpt`` (at ``iter_steps`` refinement steps)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from hmd_ego_pose_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
    from hmd_ego_pose_tpu.data.colibri import ColibriDataset
    from hmd_ego_pose_tpu.data.device_dataset import build_host_cache, gather_raw_batch, upload_window
    from hmd_ego_pose_tpu.ops.augment_device import augment_and_preprocess_batch
    from hmd_ego_pose_tpu.train.checkpoint import meta_hand_relative, restore_checkpoint
    from hmd_ego_pose_tpu.train.state import make_optimizer
    from hmd_ego_pose_tpu.train.step import _compute_losses, effective_loss_config
    from hmd_ego_pose_tpu_torch.models.weights import widen_classes

    params, bn_state, meta = restore_checkpoint(ckpt)
    ids = list(range(1, objects + 1)) if objects > 1 else None
    if ids:
        params = widen_classes(params, objects)
    cfg = Config(model=ModelConfig(phi=0, image_size=IMAGE_SIZE, num_classes=objects, iter_steps=iter_steps,
                                   hand_relative=bool(meta_hand_relative(meta))),
                 train=TrainConfig(batch_size=BATCH, learning_rate=LR),
                 data=DataConfig(dataset_path=data, use_6dof_augmentation=False, max_objects=objects,
                                 use_colorspace_augmentation=False))
    ds = ColibriDataset(data, 0, 1, "train", object_ids=ids)
    device_data = upload_window(build_host_cache(ds, objects))
    model_points = ds.model_points_for_loss(cfg.train.loss.num_model_points)
    loss_cfg = effective_loss_config(cfg)
    tx = make_optimizer(cfg.train, params)
    opt_state = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(_compute_losses, has_aux=True), static_argnums=(5, 6, 7))
    out = []
    for s in range(STEPS):
        raw = gather_raw_batch(device_data, jnp.asarray(step_indices(s)))
        batch = augment_and_preprocess_batch(jax.random.PRNGKey(0), raw, IMAGE_SIZE, use_colorspace=False,
                                             use_6dof=False)
        (total, (bundle, new_bn)), grads = grad_fn(params, bn_state, batch, None, model_points,
                                                   cfg.model, loss_cfg, cfg.train)
        out.append(dict(zip(TERMS, (float(v) for v in (bundle.total, bundle.classification,
                                                       bundle.regression, bundle.rotation,
                                                       bundle.translation, bundle.hand)))))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        bn_state = new_bn
        print(f"jax step {s}: {out[-1]}", flush=True)
    return out, cfg


def port_losses(data: str, objects: int, ckpt: str = ARTIFACT, iter_steps: int = 0):
    """The port's same four steps on the CPU (``cli.build_trainer``)."""
    import torch

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.models.weights import widen_classes
    from hmd_ego_pose_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES

    with tempfile.TemporaryDirectory() as tmp:
        extra = ["--iter", str(iter_steps)]
        if objects > 1:
            params, bn_state, meta = restore_checkpoint(ckpt, "cpu")
            ckpt = save_checkpoint(tmp, "widened", widen_classes(params, objects), bn_state,
                                   metadata={"hand_relative": meta["hand_relative"]})
            extra += ["--object-ids", ",".join(str(i) for i in range(1, objects + 1))]
        args = cli.build_parser().parse_args(["train", "--dataset-path", data, "--ckpt", ckpt,
                                              "--device", "cpu", *extra])
        trainer = cli.build_trainer(args, checkpoint_dir=tmp)
        out = []
        for s in range(STEPS):
            idx = torch.from_numpy(step_indices(s))
            m = trainer.step_fn(trainer.data, idx, None, None)
            out.append(dict(zip(TERMS, (float(m[k]) for k in METRIC_NAMES))))
            print(f"port step {s}: {out[-1]}", flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--set", default="handrel_v3", choices=sorted(SETS), help="which reference to write")
    parser.add_argument("--work-dir", default=None, help="where the set is generated (default: a temp dir)")
    parser.add_argument("--skip-port", action="store_true", help="do not run the port's CPU calibration")
    args = parser.parse_args()
    frames, objects = SETS[args.set]
    generate = generate_command(frames, objects)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(args.work_dir or tmp, f"{args.set}_{frames}_{IMAGE_SIZE}")
        if not os.path.isdir(data):
            subprocess.run([sys.executable, "-m", "hmd_ego_pose_tpu.cli", *generate, "--out-dir", data],
                           cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"), check=True,
                           capture_output=True)
        with open(os.path.join(data, "data", "01", "gt_0.yml"), "rb") as f:
            gt_hash = hashlib.sha256(f.read()).hexdigest()
        ref, cfg = jax_losses(data, objects)
        port = None if args.skip_port else port_losses(data, objects)
    gaps = None
    tolerance = {}
    if port is not None:
        gaps = [max(abs(p[t] - r[t]) / max(abs(r[t]), 1e-12) for t in TERMS) for p, r in zip(port, ref)]
    for s, floor in TOLERANCE_RULE["floor_rel"].items():
        gap = 0.0 if gaps is None else gaps[int(s)]
        tolerance[s] = max(floor, TOLERANCE_RULE["factor_over_cpu_gap"] * gap)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True,
                            text=True).stdout.strip() or None
    record = {
        "steps": ref,
        "port_cpu_steps": port,
        "port_cpu_max_rel_gap": gaps,
        "tolerance_rel": tolerance,
        "tolerance_rule": TOLERANCE_RULE,
        "batch_indices": "step s: train-split frames 16*s .. 16*s+15 (fold 0, sorted frame names)",
        "setup": {"artifact": os.path.relpath(ARTIFACT, REPO), "phi": 0, "image_size": IMAGE_SIZE,
                  "batch_size": BATCH, "optimizer": "adam", "learning_rate": LR, "freeze_backbone": True,
                  "hand_relative": cfg.model.hand_relative, "augmentation": "off",
                  "drop_connect": "off", "compute_dtype": "float32"},
        "generate": "python -m hmd_ego_pose_tpu.cli " + " ".join(generate) + " --out-dir D",
        "command": "JAX_PLATFORMS=cpu python scripts/make_train_reference.py"
                   + ("" if args.set == "handrel_v3" else f" --set {args.set}"),
        "commit": commit,
    }
    if objects > 1:
        record["gt_0_yml_sha256"] = gt_hash
        record["setup"].update({"object_ids": list(range(1, objects + 1)), "num_classes": objects,
                                "max_objects": objects,
                                "widen": "models/weights.py::widen_classes: the classifier header's "
                                         "class column copied to every class"})
    os.makedirs(REFERENCES, exist_ok=True)
    with open(os.path.join(REFERENCES, f"{args.set}_train_steps.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(record, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
