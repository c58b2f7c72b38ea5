"""Command line of the PyTorch port.

    python -m hmd_ego_pose_tpu_torch.cli train --dataset-path D --ckpt trained/syn1000_phi0_576ep_handrel_int8.npz --epo 1
    python -m hmd_ego_pose_tpu_torch.cli serve --ckpt trained/syn1000_phi0_576ep_handrel_int8.npz --port 18734
    python -m hmd_ego_pose_tpu_torch.cli make-synthetic --out-dir D --num-frames 1000 --frame-size 256 --hand-render-version 3
    python -m hmd_ego_pose_tpu_torch.cli evaluate --dataset-path D --ckpt trained/syn1000_phi0_576ep_handrel_int8.npz --partition val
    python -m hmd_ego_pose_tpu_torch.cli export --ckpt trained/syn1000_phi0_576ep_handrel_int8.npz --quantize-int8
    python -m hmd_ego_pose_tpu_torch.cli debug --dataset-path D --out-dir debug_viz
    python -m hmd_ego_pose_tpu_torch.cli format-labels --in-dir PICKLES --out-dir D
    python -m hmd_ego_pose_tpu_torch.cli parity --torch-ckpt model.pth

``train`` fine-tunes (or, without ``--ckpt``, trains from random weights) on
a fold's train split (resident on the device, in windows, or through the
host input pipeline, as ``train/trainer.py`` chooses), validates on its val
split after every ``--eval-every`` epochs and writes the best and ``last``
checkpoints into ``train_weights/`` in the JAX package's npz layout.
Launched by ``torchrun --nproc-per-node N -m hmd_ego_pose_tpu_torch.cli
train ...`` it trains data-parallel (``parallel/``): one rank per card over
NCCL, or with ``--device cpu`` gloo ranks on the CPU; the global
``--batch-size`` is split over the ranks, and only rank 0 validates, logs
and writes checkpoints.  ``--ckpt`` restores on the device (int8 leaves
through the dequantize kernel) and resumes the optimizer moments and step
count a ``last`` checkpoint carries; the hand convention comes from the
checkpoint's metadata unless ``--hand-relative`` asks for it.
``--object-ids 1,2`` trains a multi-object scene (one class per id).  Flags
and defaults are the JAX package's.

``serve`` restores the checkpoint on the device (int8 leaves dequantized by the
CUDA kernel), folds the BNs, warms the engine up and answers pose requests
over TCP until interrupted, printing the engine's latency stats every 30 s.
``make-synthetic`` writes the synthetic colibri dataset (the JAX package's
generator, same seed, same files).  ``evaluate`` restores the checkpoint,
runs the unfolded model (float32 unless the config says otherwise, with
``--iter`` refinement steps) over a fold's partition, scores every metric
(ADD-S on the min-distance kernel) and prints the 17-line report and the
scalars as JSON; ``--save-images-path`` also writes each true positive's
overlay and four-panel figure there.  Its flags and defaults are the JAX
package's, less ``--dataset`` and ``--batch-size``, which its ``evaluate``
does not read either.  ``export`` restores the checkpoint on the device,
folds the BNs, writes the ``torch.export`` program of the raw forward
(``<out-dir>/hmd_ego_pose.pt2``) with its seeded input, golden outputs and
meta JSON, loads it back and verifies it; with ``--quantize-int8`` it also
writes ``weights_fp32.npz`` and the int8 distribution checkpoint
``weights_int8.npz``, every int8 leaf quantized on the card by the CUDA
kernel.  ``debug`` draws the ground truth (boxes, cuboids, the first row's
hand) over a partition's first frames into ``debug_{i:06d}.png``;
``format-labels`` turns a directory of per-frame pickles into the LINEMOD
layout; both are host work and take no ``--device``, and ``debug`` takes
the dataset flags it reads (not ``--dataset``, ``--iter``,
``--hand-relative``, ``--img-size``, ``--phi`` or ``--batch-size``, which
the JAX ``debug`` accepts and ignores).  ``parity`` loads a reference
``.pth`` state_dict (``--torch-ckpt``) into the fp32 model and prints its
per-layer activation statistics and raw head outputs on one input.
Everything else runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from hmd_ego_pose_tpu_torch.config import ModelConfig, ServingConfig
from hmd_ego_pose_tpu_torch.train.checkpoint import meta_hand_relative


def resolve_hand_relative(flag: bool, metadata) -> bool:
    """The hand-decode convention: the checkpoint's record wins over an absent
    flag; a flag that contradicts the record is an error."""
    recorded = meta_hand_relative(metadata)
    if recorded is None:
        return flag
    if flag and not recorded:
        raise SystemExit(
            "--hand-relative was passed, but the checkpoint's metadata records "
            "hand_relative=False (absolute hand decode); drop the flag"
        )
    return recorded


def build_engine(ckpt: Optional[str], device=None, phi: int = 0, img_size: int = 256,
                 frame_size: int = 480, max_batch_size: int = 16, score_threshold: float = 0.5,
                 camera_params: Optional[str] = None, hand_relative: bool = False):
    """The serving path up to the socket: restore ``ckpt`` on the device (int8
    leaves dequantized by the CUDA kernel), build the bf16 model, fold its
    BNs in the engine and warm every batch size up.  Returns the engine."""
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose, init_weights
    from hmd_ego_pose_tpu_torch.models.weights import from_jax_params
    from hmd_ego_pose_tpu_torch.serving.engine import InferenceEngine
    from hmd_ego_pose_tpu_torch.train.checkpoint import restore_checkpoint
    from hmd_ego_pose_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    if ckpt:
        params, bn_state, meta = restore_checkpoint(ckpt, device)
        hand_relative = resolve_hand_relative(hand_relative, meta)
    model_cfg = ModelConfig(phi=phi, image_size=img_size, compute_dtype="bfloat16",
                            hand_relative=hand_relative)
    model = HMDEgoPose(model_cfg).to(device).eval()
    if ckpt:
        model.load_state_dict(from_jax_params(params, bn_state, model_cfg), strict=True)
    else:
        print("WARNING: serving randomly initialized weights (no --ckpt)")
        init_weights(model, torch.Generator().manual_seed(0))
    default_camera = None
    if camera_params:
        # [fx fy px py tz_scale image_scale], the reference's camera_params*.txt layout
        default_camera = np.loadtxt(camera_params).reshape(-1)[:6]
    engine = InferenceEngine(
        model, model_cfg,
        ServingConfig(max_batch_size=max_batch_size, score_threshold=score_threshold),
        frame_shape=(frame_size, frame_size),
        default_camera=default_camera,
        device=device,
    )
    engine.warmup()
    return engine


def start_signaling(args, server, poll_interval: float = 0.5):
    """Register ``server`` with the node-dss service at ``args.signaling_url``:
    a started ``PoseEndpointResponder`` that answers each offer to
    ``args.local_peer_id`` with the server's endpoint.  None without
    ``--signaling-url``.  The endpoint's host is ``--advertise-host``, else the
    bind host, with a wildcard bind (not dialable) advertised as 127.0.0.1."""
    if not args.signaling_url:
        return None
    from hmd_ego_pose_tpu_torch.serving.signaling_client import NodeDssSignalerClient, PoseEndpointResponder

    signaler = NodeDssSignalerClient(args.signaling_url, args.local_peer_id, args.remote_peer_id,
                                     poll_interval=poll_interval)
    host, port = server.address[:2]
    if args.advertise_host:
        host = args.advertise_host
    elif host in ("0.0.0.0", "::"):
        host = "127.0.0.1"  # wildcard bind is not dialable; --advertise-host for a LAN
    responder = PoseEndpointResponder(signaler, host, port)
    responder.start()
    return responder


def cmd_serve(args):
    from hmd_ego_pose_tpu_torch.serving.server import PoseServer

    engine = build_engine(
        args.ckpt, args.device, args.phi, args.img_size, args.frame_size, args.max_batch_size,
        args.score_threshold, args.camera_params, args.hand_relative,
    )
    server = PoseServer(engine, host=args.host, port=args.port)
    server.start()
    print(f"pose server listening on {server.address}", flush=True)
    responder = start_signaling(args, server)
    if responder is not None:
        print(f"answering offers for '{args.local_peer_id}' at {args.signaling_url}", flush=True)
    try:
        while True:
            time.sleep(30)
            print(json.dumps(engine.stats()), flush=True)
    except KeyboardInterrupt:
        if responder is not None:
            responder.stop()
        server.stop()


def _object_ids(args):
    if args.object_ids is None:
        return None
    return [int(x) for x in str(args.object_ids).split(",") if x.strip()]


def train_config(args, **train_overrides):
    """The ``Config`` of ``cli train`` from its flags (``_make_config`` of the JAX CLI)."""
    from hmd_ego_pose_tpu_torch.config import Config, DataConfig, TrainConfig

    ids = _object_ids(args)
    k = len(ids) if ids else 1
    return Config(
        model=ModelConfig(phi=args.phi, image_size=args.img_size, iter_steps=args.iter, num_classes=k,
                          hand_relative=args.hand_relative),
        train=TrainConfig(batch_size=args.batch_size, learning_rate=args.lr, epochs=args.epo,
                          fine_tune=args.fine_tune, freeze_backbone=args.freeze_backbone,
                          eval_every=args.eval_every, clip_grad_norm=args.clip_grad_norm,
                          **train_overrides),
        data=DataConfig(dataset=args.dataset, dataset_path=args.dataset_path, fold=args.fold,
                        object_id=ids[0] if ids else args.object_id, image_size=args.img_size,
                        max_objects=k),
    )


def build_trainer(args, logger=None, data_overrides=None, model_overrides=None, **train_overrides):
    """Everything ``cli train`` does before ``fit``: the datasets, the restore of
    ``--ckpt`` on the device (with its optimizer leaves and step count), the
    model report and the ``Trainer``.  ``train_overrides`` replace
    ``TrainConfig`` fields that have no flag (``oversample``,
    ``checkpoint_dir``), ``data_overrides`` and ``model_overrides`` (dicts)
    those of ``DataConfig`` and ``ModelConfig`` (``device_augment``,
    ``device_resident_budget_bytes``, ``remat_backbone``, ...)."""
    import dataclasses

    from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
    from hmd_ego_pose_tpu_torch.parallel import distributed
    from hmd_ego_pose_tpu_torch.parallel.mesh import make_mesh
    from hmd_ego_pose_tpu_torch.train.checkpoint import restore_checkpoint, restore_opt_leaves
    from hmd_ego_pose_tpu_torch.train.trainer import Trainer
    from hmd_ego_pose_tpu_torch.utils.model_stats import format_model_stats

    # under torchrun: join the process group and train data-parallel on this
    # rank's device; without it the mesh is of one process
    distributed.initialize(args.device)
    device = distributed.local_device(args.device)
    mesh = make_mesh(device=device)
    cfg = train_config(args, **train_overrides)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **(data_overrides or {})),
                              model=dataclasses.replace(cfg.model, **(model_overrides or {})))
    ids = _object_ids(args)
    train_ds = ColibriDataset(args.dataset_path, args.fold, args.object_id, "train", object_ids=ids)
    val_ds = ColibriDataset(args.dataset_path, args.fold, args.object_id, "val", object_ids=ids)

    params = bn_state = opt_leaves = None
    start_step = 0
    if args.ckpt:
        params, bn_state, meta = restore_checkpoint(args.ckpt, device)
        opt_leaves = restore_opt_leaves(args.ckpt)
        start_step = int(meta.get("train_step", 0))
        print(f"restored checkpoint {args.ckpt}: {meta.get('metric')}"
              f" (opt moments: {'yes' if opt_leaves else 'no'})")
        recorded = meta_hand_relative(meta)
        if recorded is not None and recorded != cfg.model.hand_relative:
            if args.hand_relative:
                print(f"WARNING: the checkpoint was trained with hand_relative={recorded}, this run "
                      f"uses {cfg.model.hand_relative}: the hand tower will relearn its output convention")
            else:
                print(f"checkpoint metadata records hand_relative={recorded}: training with it")
                cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, hand_relative=recorded))
    trainer = Trainer(cfg, train_ds, val_ds, device=device, logger=logger, params=params,
                      bn_state=bn_state, opt_leaves=opt_leaves, start_step=start_step, mesh=mesh)
    if trainer.is_main:
        print(format_model_stats(trainer.model, cfg.model.image_size, batch_size=1))
    return trainer


def cmd_train(args):
    import torch.distributed as dist

    trainer = build_trainer(args)
    try:
        best = trainer.fit()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"best checkpoint: {best}")
    return best


def cmd_evaluate(args):
    from hmd_ego_pose_tpu_torch.config import Config
    from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
    from hmd_ego_pose_tpu_torch.eval.evaluator import evaluate_model, format_report
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
    from hmd_ego_pose_tpu_torch.models.weights import from_jax_params
    from hmd_ego_pose_tpu_torch.train.checkpoint import restore_checkpoint
    from hmd_ego_pose_tpu_torch.train.step import make_eval_forward
    from hmd_ego_pose_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    ids = _object_ids(args)
    ds = ColibriDataset(args.dataset_path, args.fold, args.object_id, args.partition, object_ids=ids)
    params, bn_state, meta = restore_checkpoint(args.ckpt, device)
    cfg = Config(model=ModelConfig(phi=args.phi, image_size=args.img_size, iter_steps=args.iter,
                                   num_classes=len(ids) if ids else 1,
                                   hand_relative=resolve_hand_relative(args.hand_relative, meta)))
    model = HMDEgoPose(cfg.model).to(device).eval()
    model.load_state_dict(from_jax_params(params, bn_state, cfg.model), strict=True)
    result = evaluate_model(ds, make_eval_forward(model, cfg, device, args.score_threshold), cfg, device,
                            save_path=args.save_images_path)
    if result.per_class and len(result.per_class) > 1:
        for c, r in sorted(result.per_class.items()):
            print(f"--- class {c} ({ds.class_to_name.get(c, str(c))}) ---")
            print(format_report(r))
        print("--- class mean ---")
    print(format_report(result))
    print(json.dumps(result.scalars(), indent=2))
    return result


def cmd_make_synthetic(args):
    from hmd_ego_pose_tpu_torch.data.synthetic import generate_synthetic_colibri

    path = generate_synthetic_colibri(
        args.out_dir, num_frames=args.num_frames,
        image_size=(args.frame_size, args.frame_size),
        num_objects=args.num_objects,
        hand_render_version=args.hand_render_version,
        render_scale=args.render_scale,
    )
    print(f"synthetic colibri dataset at {path}")
    return path


def cmd_export(args):
    """Restore (or, without ``--ckpt``, seed-initialise) the model, export and
    verify the folded raw forward, and with ``--quantize-int8`` write the
    fp32 and int8 weight checkpoints.  Returns the output directory."""
    from hmd_ego_pose_tpu_torch.export.pt2 import export_inference, load_and_verify
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose, init_weights
    from hmd_ego_pose_tpu_torch.models.weights import to_jax_params
    from hmd_ego_pose_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from hmd_ego_pose_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    hand_relative = args.hand_relative
    if args.ckpt:
        params, bn_state, meta = restore_checkpoint(args.ckpt, device)
        hand_relative = resolve_hand_relative(args.hand_relative, meta)
        if hand_relative and not args.hand_relative:
            print("[cli] checkpoint metadata records hand_relative=True -> "
                  "enabling the drill-anchored hand decode (no --hand-relative "
                  "flag needed for artifacts with metadata)")
    cfg = ModelConfig(phi=args.phi, image_size=args.img_size, hand_relative=hand_relative)
    if not args.ckpt:
        model = init_weights(HMDEgoPose(cfg), torch.Generator().manual_seed(0))
        params, bn_state = to_jax_params(model.state_dict(), cfg)
    out = export_inference(params, bn_state, cfg, args.out_dir, device=device)
    load_and_verify(args.out_dir, device=device)
    print(f"exported + verified torch.export artifact in {out}")

    if args.quantize_int8:
        # distribution artifact: int8 weight checkpoint (~4x smaller), which
        # restore_checkpoint of either package dequantizes transparently
        fp32_path = save_checkpoint(args.out_dir, "weights_fp32", params, bn_state)
        int8_path = save_checkpoint(args.out_dir, "weights_int8", params, bn_state, backend="int8",
                                    device=device)
        fp32_mb = os.path.getsize(fp32_path) / 1e6
        int8_mb = os.path.getsize(int8_path) / 1e6
        print(f"int8 checkpoint: {int8_mb:.1f} MB vs fp32 {fp32_mb:.1f} MB "
              f"({fp32_mb / int8_mb:.2f}x smaller)")
    return out


def cmd_debug(args):
    """Draw the ground truth over a partition's first ``--num-images`` frames
    (every object's box and cuboid, the first object's hand) into
    ``debug_{i:06d}.png``; returns the paths."""
    from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
    from hmd_ego_pose_tpu_torch.data.image import write_png
    from hmd_ego_pose_tpu_torch.utils.visualization import render_frame

    ds = ColibriDataset(args.dataset_path, args.fold, args.object_id, args.partition,
                        object_ids=_object_ids(args))
    os.makedirs(args.out_dir, exist_ok=True)
    paths = []
    for i in range(min(len(ds), args.num_images)):
        anno = ds.load_annotations(i)
        cam = ds.load_camera_matrix(i)
        out = ds.load_image(i)
        for r in range(anno["labels"].shape[0]):  # every object of the frame
            out = render_frame(
                out, cam,
                model_info=ds.models_info[int(anno["labels"][r])],
                gt_pose=(anno["rotations"][r, :3], anno["translations"][r]),
                gt_box=anno["bboxes"][r],
                hand_3d=anno["coords_3d"][r] if r == 0 else None,
            )
        paths.append(os.path.join(args.out_dir, f"debug_{i:06d}.png"))
        write_png(paths[-1], out)
    print(f"wrote {len(paths)} overlays to {args.out_dir}")
    return paths


def cmd_format_labels(args):
    """Every ``*.pkl`` / ``*.pickle`` of ``--in-dir`` (sorted) -> the LINEMOD layout at ``--out-dir``."""
    import glob

    from hmd_ego_pose_tpu_torch.data.format_labels import convert_pickles

    paths = sorted(glob.glob(os.path.join(args.in_dir, "*.pkl")) +
                   glob.glob(os.path.join(args.in_dir, "*.pickle")))
    if not paths:
        raise SystemExit(f"no .pkl/.pickle files under {args.in_dir}")
    out = convert_pickles(paths, args.out_dir, object_id=args.object_id, fold=args.fold)
    print(f"{len(paths)} frames -> LINEMOD layout at {out}")
    return out


PARITY_FIELDS = ("regression", "classification", "rotation", "translation_raw", "hand")


def cmd_parity(args):
    """Load a reference torch state_dict into the fp32 model and print the
    per-layer activation statistics (mean / std / absmax of the backbone's and
    every BiFPN cell's outputs) and the first anchor row of the five raw heads
    on ``--input`` (NCHW or NHWC ``.npy``) or a seeded uniform input: the
    per-layer diffing harness for checkpoint parity.  Without ``--torch-ckpt``
    the port's own seeded init (torch generator, seed 0) runs, which is not
    the JAX package's ``init_host(0)``.  Returns ``{"report", "stats": {name:
    (mean, std, absmax)}, "heads": {field: first six values}}``."""
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose, apply, init_weights
    from hmd_ego_pose_tpu_torch.models.weights import load_torch_state_dict
    from hmd_ego_pose_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = ModelConfig(phi=args.phi, image_size=args.img_size)
    model = init_weights(HMDEgoPose(cfg), torch.Generator().manual_seed(0))
    report = None
    if args.torch_ckpt:
        state_dict = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
        report = load_torch_state_dict(model, state_dict, strict=not args.lenient)
        print(f"converted: {len(report['missing'])} missing, {len(report['unused'])} unused keys")
    model = model.to(device)

    if args.input:
        x = np.load(args.input)
        if x.ndim == 4 and x.shape[1] == 3:  # NCHW (the reference's input.npy) -> NHWC
            x = x.transpose(0, 2, 3, 1)
    else:
        x = np.random.RandomState(0).uniform(-1, 1, size=(1, args.img_size, args.img_size, 3)).astype(np.float32)

    capture: dict = {}
    out = apply(model, torch.as_tensor(np.asarray(x, np.float32)).to(device), cfg, capture=capture)
    stats, heads = {}, {}
    print("\nper-layer activation stats (mean / std / absmax):")
    for name in sorted(capture):
        # NHWC as the JAX package holds it, so numpy reduces in the same order
        a = capture[name].float().permute(0, 2, 3, 1).contiguous().cpu().numpy()
        stats[name] = (float(a.mean()), float(a.std()), float(np.abs(a).max()))
        print(f"  {name:24s} {a.mean():+.6f} {a.std():.6f} {np.abs(a).max():.6f}")
    print("\nraw head outputs (first anchor row), cf. scratchpad.py:78-87:")
    for field in PARITY_FIELDS:
        a = getattr(out, field).cpu().numpy()
        heads[field] = [float(v) for v in a[0, 0, :6]]
        print(f"  {field:16s} {a[0, 0, :6]}")
    return {"report": report, "stats": stats, "heads": heads}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="hmd_ego_pose_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="train or fine-tune a model", allow_abbrev=False)
    p.add_argument("--dataset", default="syn_colibri", choices=["syn_colibri", "real_colibri"])
    p.add_argument("--dataset-path", required=True, help="root with data/ and models/")
    p.add_argument("--fold", type=int, default=0, help="cross-validation fold [0..4]")
    p.add_argument("--object-id", type=int, default=1)
    p.add_argument("--object-ids", default=None,
                   help="comma-separated ids of a multi-object scene: one class per id, read from the "
                        "first id's scene dir")
    p.add_argument("--iter", type=int, default=0, help="iterative refinement steps")
    p.add_argument("--hand-relative", action="store_true",
                   help="regress the hand relative to the object translation (ModelConfig.hand_relative); "
                        "with --ckpt the checkpoint's record is used unless this flag is passed")
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--phi", type=int, default=0, help="EfficientDet compound coefficient")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--epo", type=int, default=50)
    p.add_argument("--fine-tune", action="store_true", help="SGD+Nesterov instead of Adam")
    p.add_argument("--eval-every", type=int, default=1, help="validate/checkpoint every N epochs")
    p.add_argument("--freeze-backbone", action="store_true", default=True)
    p.add_argument("--no-freeze-backbone", dest="freeze_backbone", action="store_false")
    p.add_argument("--clip-grad-norm", type=float, default=0.0,
                   help="global-norm gradient clip before the optimizer (0 = off)")
    p.add_argument("--ckpt", default=None, help=".npz checkpoint to start from (fp32 or int8)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(func=cmd_train)

    # no abbreviations: the JAX CLI's --dataset must not pass for --dataset-path
    p = sub.add_parser("evaluate", help="evaluate a checkpoint on a colibri partition", allow_abbrev=False)
    p.add_argument("--dataset-path", required=True, help="root with data/ and models/")
    p.add_argument("--fold", type=int, default=0, help="cross-validation fold [0..4]")
    p.add_argument("--object-id", type=int, default=1)
    p.add_argument("--object-ids", default=None,
                   help="comma-separated ids of a multi-object scene; sets num_classes")
    p.add_argument("--iter", type=int, default=0, help="iterative refinement steps")
    p.add_argument("--hand-relative", action="store_true",
                   help="the checkpoint was trained with ModelConfig.hand_relative")
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--phi", type=int, default=0, help="EfficientDet compound coefficient")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--partition", default="test", choices=["train", "val", "test"])
    p.add_argument("--score-threshold", type=float, default=0.5)
    p.add_argument("--save-images-path", default=None,
                   help="write detection overlays + samplevis panels here")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(func=cmd_evaluate)

    p = sub.add_parser("make-synthetic", help="generate a synthetic colibri dataset")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--num-frames", type=int, default=50)
    p.add_argument("--frame-size", type=int, default=480)
    p.add_argument("--num-objects", type=int, default=1,
                   help=">1 writes a multi-object scene (per-object mask values + mask_values.yml)")
    p.add_argument("--hand-render-version", type=int, default=2, choices=(2, 3),
                   help="3 = grip-distance placement, 1/z joint radii, palm-orientation "
                        "arrows (the shipped 576ep artifact's data); 2 keeps older seed-0 sets")
    p.add_argument("--render-scale", type=int, default=1,
                   help="integer scale s: with --frame-size 256*s renders the same seed "
                        "scenes at s-x resolution")
    p.set_defaults(func=cmd_make_synthetic)
    p = sub.add_parser("serve", help="pose-streaming server over TCP")
    p.add_argument("--signaling-url", default=None,
                   help="node-dss signaling service to register with (e.g. http://host:3000/)")
    p.add_argument("--local-peer-id", default="workstation")
    p.add_argument("--remote-peer-id", default="hmd")
    p.add_argument("--advertise-host", default=None,
                   help="endpoint host to advertise in signaling answers (default: bind host)")
    p.add_argument("--ckpt", default=None, help=".npz checkpoint (fp32 or int8)")
    p.add_argument("--phi", type=int, default=0)
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--frame-size", type=int, default=480)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=18734)
    p.add_argument("--max-batch-size", type=int, default=16)
    p.add_argument("--score-threshold", type=float, default=0.5)
    p.add_argument("--camera-params", default=None,
                   help="txt file of [fx fy px py tz_scale image_scale]")
    p.add_argument("--hand-relative", action="store_true",
                   help="the checkpoint was trained with ModelConfig.hand_relative")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("export", help="torch.export of the folded raw forward + verify", allow_abbrev=False)
    p.add_argument("--quantize-int8", action="store_true",
                   help="also write an int8-quantized weight checkpoint for distribution "
                        "(quantized by the CUDA kernel on the card)")
    p.add_argument("--ckpt", default=None,
                   help=".npz checkpoint (fp32 or int8); without it the port's own seeded init "
                        "(torch generator, seed 0) is exported, which is not the JAX package's "
                        "init(0): the two draw from different generators")
    p.add_argument("--phi", type=int, default=0)
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--out-dir", default="artifacts")
    p.add_argument("--hand-relative", action="store_true",
                   help="the checkpoint was trained with ModelConfig.hand_relative")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(func=cmd_export)

    p = sub.add_parser("debug", help="dataset/annotation viewer", allow_abbrev=False)
    p.add_argument("--dataset-path", required=True, help="root with data/ and models/")
    p.add_argument("--fold", type=int, default=0, help="cross-validation fold [0..4]")
    p.add_argument("--object-id", type=int, default=1)
    p.add_argument("--object-ids", default=None,
                   help="comma-separated ids of a multi-object scene, read from the first id's scene dir")
    p.add_argument("--partition", default="train")
    p.add_argument("--out-dir", default="debug_viz")
    p.add_argument("--num-images", type=int, default=10)
    p.set_defaults(func=cmd_debug)

    p = sub.add_parser("parity", help="torch-checkpoint load + activation diffing harness", allow_abbrev=False)
    p.add_argument("--torch-ckpt", default=None, help="reference .pth state_dict")
    p.add_argument("--input", default=None, help=".npy input (NCHW or NHWC), e.g. onnx-models/input.npy")
    p.add_argument("--phi", type=int, default=0)
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--lenient", action="store_true", help="tolerate missing/extra keys")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(func=cmd_parity)

    p = sub.add_parser("format-labels", help="pickle dumps -> LINEMOD dataset")
    p.add_argument("--in-dir", required=True, help="directory of per-frame .pkl files")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--object-id", type=int, default=1)
    p.add_argument("--fold", type=int, default=0)
    p.set_defaults(func=cmd_format_labels)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    main()
