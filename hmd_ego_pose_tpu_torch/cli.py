"""Command line of the PyTorch port.

    python -m hmd_ego_pose_tpu_torch.cli serve --ckpt trained/syn1000_phi0_576ep_handrel_int8.npz --port 18734
    python -m hmd_ego_pose_tpu_torch.cli make-synthetic --out-dir D --num-frames 1000 --frame-size 256 --hand-render-version 3
    python -m hmd_ego_pose_tpu_torch.cli evaluate --dataset-path D --ckpt trained/syn1000_phi0_576ep_handrel_int8.npz --partition val

``serve`` restores the checkpoint on the device (int8 leaves dequantized by the
CUDA kernel), folds the BNs, warms the engine up and answers pose requests
over TCP until interrupted, printing the engine's latency stats every 30 s.
``make-synthetic`` writes the synthetic colibri dataset (the JAX package's
generator, same seed, same files).  ``evaluate`` restores the checkpoint,
runs the unfolded model (float32 unless the config says otherwise) over a
fold's partition, scores every metric (ADD-S on the min-distance kernel)
and prints the 17-line report and the scalars as JSON.  Flags and defaults
are the JAX package's, less ``--dataset`` and ``--batch-size``, which its
``evaluate`` does not read either; ``--save-images-path`` and ``--iter`` > 0
are not ported and raise.  Everything runs on ``cuda`` unless ``--device cpu`` is
given.  The JAX package's other subcommands are not ported yet.
"""

from __future__ import annotations

import argparse
import json
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


def cmd_serve(args):
    from hmd_ego_pose_tpu_torch.serving.server import PoseServer

    engine = build_engine(
        args.ckpt, args.device, args.phi, args.img_size, args.frame_size, args.max_batch_size,
        args.score_threshold, args.camera_params, args.hand_relative,
    )
    server = PoseServer(engine, host=args.host, port=args.port)
    server.start()
    print(f"pose server listening on {server.address}", flush=True)
    try:
        while True:
            time.sleep(30)
            print(json.dumps(engine.stats()), flush=True)
    except KeyboardInterrupt:
        server.stop()


def _object_ids(args):
    if args.object_ids is None:
        return None
    return [int(x) for x in str(args.object_ids).split(",") if x.strip()]


def make_eval_predict(model, config, device, score_threshold: float):
    """The evaluator's predict callable over ``model`` (unfolded): numpy
    (images, cameras) -> detections on ``device``."""
    from hmd_ego_pose_tpu_torch.models import hmd_ego_pose

    def predict(images: np.ndarray, cameras: np.ndarray):
        return hmd_ego_pose.predict(
            model, torch.from_numpy(images).to(device), torch.from_numpy(cameras).to(device),
            config.model, score_threshold=score_threshold,
            iou_threshold=config.eval.nms_threshold, max_detections=config.eval.max_detections,
        )

    return predict


def cmd_evaluate(args):
    from hmd_ego_pose_tpu_torch.config import Config
    from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
    from hmd_ego_pose_tpu_torch.eval.evaluator import evaluate_model, format_report
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
    from hmd_ego_pose_tpu_torch.models.weights import from_jax_params
    from hmd_ego_pose_tpu_torch.train.checkpoint import restore_checkpoint
    from hmd_ego_pose_tpu_torch.utils.device import resolve_device

    if args.save_images_path is not None:
        raise SystemExit("--save-images-path (detection overlays) is not ported to the PyTorch package")
    if args.iter:
        raise SystemExit("--iter > 0 (iterative refinement) is not ported to the PyTorch package")
    device = resolve_device(args.device)
    ids = _object_ids(args)
    ds = ColibriDataset(args.dataset_path, args.fold, args.object_id, args.partition, object_ids=ids)
    params, bn_state, meta = restore_checkpoint(args.ckpt, device)
    cfg = Config(model=ModelConfig(phi=args.phi, image_size=args.img_size,
                                   num_classes=len(ids) if ids else 1,
                                   hand_relative=resolve_hand_relative(args.hand_relative, meta)))
    model = HMDEgoPose(cfg.model).to(device).eval()
    model.load_state_dict(from_jax_params(params, bn_state, cfg.model), strict=True)
    result = evaluate_model(ds, make_eval_predict(model, cfg, device, args.score_threshold), cfg, device)
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="hmd_ego_pose_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    # no abbreviations: the JAX CLI's --dataset must not pass for --dataset-path
    p = sub.add_parser("evaluate", help="evaluate a checkpoint on a colibri partition", allow_abbrev=False)
    p.add_argument("--dataset-path", required=True, help="root with data/ and models/")
    p.add_argument("--fold", type=int, default=0, help="cross-validation fold [0..4]")
    p.add_argument("--object-id", type=int, default=1)
    p.add_argument("--object-ids", default=None,
                   help="comma-separated ids of a multi-object scene; sets num_classes")
    p.add_argument("--iter", type=int, default=0, help="iterative refinement steps (only 0 is ported)")
    p.add_argument("--hand-relative", action="store_true",
                   help="the checkpoint was trained with ModelConfig.hand_relative")
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--phi", type=int, default=0, help="EfficientDet compound coefficient")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--partition", default="test", choices=["train", "val", "test"])
    p.add_argument("--score-threshold", type=float, default=0.5)
    p.add_argument("--save-images-path", default=None, help="not ported: raises")
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
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    main()
