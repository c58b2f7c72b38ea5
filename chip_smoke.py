#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``hmd_ego_pose_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line of its own:

1. device   -- the card's name and power limit (nvidia-smi).
2. build    -- every CUDA kernel of the port built from ``csrc/`` with nvcc,
               one process per source, all at once.
3. kernel   -- the dequantize kernel against its plain PyTorch version on the
               card, on every int8 leaf of the shipped artifact and on seeded odd
               shapes: bit equality required; kernel, plain and one-call
               PyTorch times over all leaves, beside the bytes bound.
4. kernel_min_distances -- the ADD-S min-distance kernel against its plain
               version at the evaluation's shape (T=200 pose pairs, P=Q=600)
               and at seeded odd shapes, with duplicate points: bit equality
               required; kernel, plain and ``torch.cdist(...).amin`` times at
               the evaluation's shape, beside the operations bound.
5. predict  -- restore of ``trained/syn1000_phi0_576ep_handrel_int8.npz`` on the
               card, then ``predict`` (phi-0, 256 px, bf16, score threshold
               0.1) of the six committed golden frames, held to
               ``tests/goldens/handrel_ckpt_expected.npz``
               (``hmd_ego_pose_tpu_torch/eval/golden.py`` states the bounds);
               and the device preprocess of a seeded 300x300 frame, which must
               equal the CPU's bit for bit, with its time and that of a
               1080x1920 frame (to 256 px).
6. serve    -- the serving path as ``cli serve`` builds it (restore, BN fold,
               engine warm-up) behind a ``PoseServer`` on 127.0.0.1, port 0; a
               ``PoseClient`` sends the six frames as RGB8 and the pose packets
               are held to the goldens.  Kernel launch counts are reset just
               before this phase and read just after it.
7. evaluate -- ``cli make-synthetic`` writes the 1000-frame, 256 px, seed-0,
               hand-render-v3 set into a temporary directory, whose
               ``gt_0.yml`` must hash as the JAX generator's did; then
               ``cli evaluate`` of the shipped artifact on its 200 val frames
               (fp32, unfolded), on the card, with the launch counts reset just
               before and read just after: ``min_distances`` must launch exactly
               once (one class), and every scalar must lie within the stated
               tolerances of ``hmd_ego_pose_tpu_torch/eval/references/handrel_v3_val.json``
               (the JAX package's evaluation, ``scripts/make_eval_reference.py``).
8. shutdown -- server and engine stopped, every thread joined with a timeout.

Then the ``kernels`` JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero without that line.  It exits non-zero at once without a CUDA device
or without the repository beside it.  A watchdog turns a hang into a
traceback and a non-zero exit.
"""

from __future__ import annotations

import contextlib
import faulthandler
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(HERE, "trained", "syn1000_phi0_576ep_handrel_int8.npz")
GOLDEN = os.path.join(HERE, "tests", "goldens")
EVAL_REFERENCE = os.path.join(HERE, "hmd_ego_pose_tpu_torch", "eval", "references", "handrel_v3_val.json")
WATCHDOG_S = 900
# the odd shapes the kernel must also take: a single row, widths off 32/128
ODD_SHAPES = ((1, 1), (1, 300), (5, 33), (7, 1000), (130, 97), (3, 129))
# (T, P, Q) of the min-distance kernel: the evaluation's shape first, then a
# single point, widths off 128, more Q than one shared-memory chunk (1024),
# and the 1000-point cap the ADD-S stride sets for a dense mesh
MIN_DIST_EVAL_SHAPE = (200, 600, 600)
MIN_DIST_SHAPES = (MIN_DIST_EVAL_SHAPE, (1, 1, 1), (3, 700, 513), (2, 5000, 4999), (64, 1000, 1000))
# the card's evaluation against the JAX package's (fp32 on both sides)
EVAL_TOLERANCES = {"count": 0.0, "accuracy": 0.005, "mm": 0.05, "deg": 0.01}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after a warm-up, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def int8_leaves(path: str):
    """(values reshaped to (R, C), scales) of every int8 leaf of an artifact, in file order."""
    import numpy as np

    with np.load(path) as data:
        names = [k[: -len("/int8")] for k in data.files if k.endswith("/int8")]
        # stored arrays may be Fortran-ordered; the kernel takes row-major (R, C)
        return [(np.ascontiguousarray(data[n + "/int8"].reshape(-1, data[n + "/int8"].shape[-1])),
                 np.ascontiguousarray(data[n + "/scales"])) for n in names]


def phase_kernel(dev) -> dict:
    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch.kernels import bounds
    from hmd_ego_pose_tpu_torch.ops.quantization import dequantize, dequantize_reference

    leaves = [(torch.from_numpy(v).to(dev), torch.from_numpy(s).to(dev)) for v, s in int8_leaves(ARTIFACT)]
    rng = np.random.default_rng(0)
    odd = [(torch.from_numpy(rng.integers(-127, 128, size=shape, dtype=np.int8)).to(dev),
            torch.from_numpy(rng.uniform(1e-4, 1e-1, size=shape[1]).astype(np.float32)).to(dev))
           for shape in ODD_SHAPES]
    max_err = 0.0
    for v, s in leaves + odd:
        got, want = dequantize(v, s), dequantize_reference(v, s)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"dequantize differs from its plain version at {tuple(v.shape)}: "
                                 f"max |diff| {(got - want).abs().max().item()}")
        max_err = max(max_err, (got - want).abs().max().item())

    def all_leaves(fn):
        return lambda: [fn(v, s) for v, s in leaves]

    ms = cuda_time_ms(all_leaves(dequantize))
    plain_ms = cuda_time_ms(all_leaves(dequantize_reference))
    library_ms = cuda_time_ms(all_leaves(lambda v, s: torch.mul(v, s)))  # one call, int8 * f32 -> f32
    values = sum(v.numel() for v, _ in leaves)
    scales = sum(s.numel() for _, s in leaves)
    return {
        "leaves": len(leaves), "int8_values": values, "odd_shapes": [list(s) for s in ODD_SHAPES],
        "bit_equal": True, "max_abs_err": max_err, "kernel_ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, **bounds.bound(*bounds.dequantize_work(values, scales)),
        "kernels": ["dequantize"],
    }


def point_pairs(rng, t: int, p: int, q: int):
    """Seeded GT and pred point sets (T, P, 3), (T, Q, 3) in mm, hundreds of mm
    from the camera, with duplicate points inside and across the two sets."""
    import numpy as np

    center = np.stack([rng.uniform(-60, 60, t), rng.uniform(-60, 60, t), rng.uniform(400, 700, t)], axis=1)
    gt = (rng.uniform(-60, 60, (t, p, 3)) + center[:, None, :]).astype(np.float32)
    pred = (rng.uniform(-60, 60, (t, q, 3)) + center[:, None, :]).astype(np.float32)
    k = min(p, q) // 4
    if k:
        pred[:, q - k:] = pred[:, :k]  # duplicates among the preds
        gt[:, :k] = pred[:, :k]  # GT points that sit on a pred point: distance 0
    return gt, pred


def phase_min_distances(dev) -> dict:
    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch.kernels import bounds
    from hmd_ego_pose_tpu_torch.ops.distances import min_distances, min_distances_reference

    rng = np.random.default_rng(5)
    max_err, checked = 0.0, []
    for shape in MIN_DIST_SHAPES:
        g, p = (torch.from_numpy(a).to(dev) for a in point_pairs(rng, *shape))
        got, want = min_distances(g, p), min_distances_reference(g, p)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"min_distances differs from its plain version at {shape}: "
                                 f"max |diff| {(got - want).abs().max().item()}")
        max_err = max(max_err, (got - want).abs().max().item())
        checked.append(list(shape))
        if shape == MIN_DIST_EVAL_SHAPE:
            eval_inputs, eval_want = (g, p), want

    g, p = eval_inputs
    ms = cuda_time_ms(lambda: min_distances(g, p))
    plain_ms = cuda_time_ms(lambda: min_distances_reference(g, p))
    library_ms = cuda_time_ms(lambda: torch.cdist(g, p).amin(dim=-1))  # the one-call yardstick
    library_dev = (torch.cdist(g, p).amin(dim=-1) - eval_want).abs().max().item()
    return {
        "shapes": checked, "bit_equal": True, "max_abs_err": max_err,
        "eval_shape": list(MIN_DIST_EVAL_SHAPE), "kernel_ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "library": "torch.cdist(g, p).amin(-1)",
        "library_max_abs_dev_mm": library_dev,
        **bounds.bound(*bounds.min_distances_work(g.shape[0], g.shape[1], p.shape[1])),
    }


def read_golden():
    import numpy as np

    from hmd_ego_pose_tpu_torch.data.image import read_png

    golden = dict(np.load(os.path.join(GOLDEN, "handrel_ckpt_expected.npz")).items())
    n = int(golden["n_frames"])
    frames = np.stack([read_png(os.path.join(GOLDEN, f"handrel_ckpt_frame_{i}.png")) for i in range(n)])
    cameras = np.concatenate([golden[f"camera_{i}"] for i in range(n)]).astype(np.float32)
    return golden, frames, cameras


def phase_predict(dev, golden, frames, cameras) -> tuple:
    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.eval import golden as hold
    from hmd_ego_pose_tpu_torch.models import hmd_ego_pose
    from hmd_ego_pose_tpu_torch.ops.preprocess import preprocess_uint8_batch
    from hmd_ego_pose_tpu_torch.models.weights import from_jax_params
    from hmd_ego_pose_tpu_torch.train.checkpoint import meta_hand_relative, restore_checkpoint

    t0 = time.perf_counter()
    params, bn_state, meta = restore_checkpoint(ARTIFACT, dev)
    cfg = ModelConfig(phi=0, image_size=256, compute_dtype="bfloat16",
                      hand_relative=bool(meta_hand_relative(meta)))
    model = hmd_ego_pose.HMDEgoPose(cfg).to(dev).eval()
    model.load_state_dict(from_jax_params(params, bn_state, cfg), strict=True)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    cams = torch.from_numpy(cameras).to(dev)
    images = preprocess_uint8_batch(torch.from_numpy(frames).to(dev), cfg.image_size)
    t1 = time.perf_counter()
    outputs = hmd_ego_pose.apply(model, images, cfg)
    dets = hmd_ego_pose.detect(outputs, cams, cfg, score_threshold=0.1)
    torch.cuda.synchronize()
    t_predict = time.perf_counter() - t1
    for name, t in zip(("regression", "classification", "rotation", "translation_raw", "hand"), outputs[1:]):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite {name} output")
    reports = [hold.hold_frame(hold.top_detection(dets, i), hold.tied_candidates(outputs, cams, i, cfg),
                               golden, i, cfg.hand_relative) for i in range(len(frames))]
    bad = [r for r in reports if not r["ok"]]
    if bad:
        raise AssertionError(f"predictions off the goldens: {bad}")
    frame300 = torch.from_numpy(
        np.random.default_rng(300).integers(0, 256, size=(1, 300, 300, 3), dtype=np.uint8))
    on_card = preprocess_uint8_batch(frame300.to(dev), cfg.image_size).cpu()
    if not torch.equal(on_card, preprocess_uint8_batch(frame300, cfg.image_size)):
        raise AssertionError("the device preprocess of a 300x300 frame differs between the card and the CPU")
    frame1080 = torch.from_numpy(
        np.random.default_rng(1080).integers(0, 256, size=(1, 1080, 1920, 3), dtype=np.uint8)).to(dev)
    preprocess_ms = {f"{f.shape[1]}x{f.shape[2]}": cuda_time_ms(lambda f=f: preprocess_uint8_batch(f, cfg.image_size))
                     for f in (frame300.to(dev), frame1080)}
    fields = {
        "artifact": os.path.relpath(ARTIFACT, HERE), "frames": len(frames),
        "preprocess_300_card_equals_cpu": True, "preprocess_ms": preprocess_ms,
        "hand_relative": cfg.hand_relative, "restore_s": t_restore, "predict_s": t_predict,
        "worst": hold.worst(reports), "tolerances": hold.TOLERANCES,
        "tie_switches": sum(r["tie_switch"] for r in reports),
    }
    return fields, outputs, cams, cfg


def phase_serve(dev, golden, frames, outputs, cams, cfg, card: str) -> dict:
    import numpy as np

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.eval import golden as hold
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.serving.server import PoseClient, PoseServer

    LAUNCHES.reset()
    t0 = time.perf_counter()
    engine = cli.build_engine(ARTIFACT, dev, frame_size=frames.shape[1], score_threshold=0.1)
    server = PoseServer(engine, host="127.0.0.1", port=0).start()
    t_start = time.perf_counter() - t0
    host, port = server.address
    rtts, reports = [], []
    try:
        with PoseClient(host, port, timeout=60.0) as client:
            for i, frame in enumerate(frames):
                t = time.perf_counter()
                pose = client.infer(frame)
                rtts.append((time.perf_counter() - t) * 1e3)
                if pose is None:
                    raise AssertionError(f"frame {i}: no detection served")
                rotation, translation_m = pose
                report = hold.hold_frame(
                    {"rotation": rotation, "translation": translation_m * 1000.0},
                    hold.tied_candidates(outputs, cams, i, cfg), golden, i, cfg.hand_relative,
                    quantities=("rotation", "translation"),
                )
                if not report["ok"]:
                    raise AssertionError(f"served pose off the golden: {report}")
                reports.append(report)
        stats = engine.stats()
    finally:
        server.stop(timeout=10.0)
    launches = LAUNCHES.snapshot()
    return {
        "frames": len(reports), "startup_s": t_start,
        "worst": hold.worst(reports),
        "tie_switches": sum(r["tie_switch"] for r in reports),
        "rtt_ms_p50": float(np.percentile(rtts, 50)), "rtt_ms_max": max(rtts),
        "engine_stats": stats, "launches": launches, "card": card,
    }


def scalar_kind(name: str) -> str:
    if name == "num_matched":
        return "count"
    if name.endswith("_deg"):
        return "deg"
    if name.endswith("_mm"):
        return "mm"
    return "accuracy"  # mean_ap and every accuracy


def phase_evaluate(card: str) -> dict:
    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES

    with open(EVAL_REFERENCE) as f:
        reference = json.load(f)
    with open(ARTIFACT[: -len(".npz")] + ".json") as f:
        sidecar = json.load(f)["eval"]
    with tempfile.TemporaryDirectory(prefix="hegp_v3_") as tmp:
        data = os.path.join(tmp, "syn1000_v3_256")
        t0 = time.perf_counter()
        cli.main(["make-synthetic", "--out-dir", data, "--num-frames", "1000", "--frame-size", "256",
                  "--hand-render-version", "3"])
        t_generate = time.perf_counter() - t0
        with open(os.path.join(data, "data", "01", "gt_0.yml"), "rb") as f:
            gt_hash = hashlib.sha256(f.read()).hexdigest()
        if gt_hash != reference["gt_0_yml_sha256"]:
            raise AssertionError(f"the port's gt_0.yml hashes {gt_hash}, the JAX generator's "
                                 f"{reference['gt_0_yml_sha256']}: the generators disagree")
        t1 = time.perf_counter()
        frames = len(ColibriDataset(data, 0, 1, "val"))
        t_read = time.perf_counter() - t1
        report = io.StringIO()
        LAUNCHES.reset()
        t2 = time.perf_counter()
        with contextlib.redirect_stdout(report):
            result = cli.main(["evaluate", "--dataset-path", data, "--ckpt", ARTIFACT, "--partition", "val"])
        t_evaluate = time.perf_counter() - t2
        launches = LAUNCHES.snapshot()
    print(report.getvalue().split("\n{")[0], flush=True)  # the 17-line report

    got = result.scalars()
    worst = {kind: 0.0 for kind in EVAL_TOLERANCES}
    off = []
    for name, want in reference["scalars"].items():
        kind = scalar_kind(name)
        gap = abs(got[name] - want)
        worst[kind] = max(worst[kind], gap)
        if gap > EVAL_TOLERANCES[kind] + 1e-12:
            off.append(f"{name}: card {got[name]!r}, JAX {want!r}, gap {gap:.6g} > {EVAL_TOLERANCES[kind]}")
    if off:
        raise AssertionError("the card's evaluation is off the JAX reference:\n" + "\n".join(off))
    if launches.get("min_distances", 0) != 1:
        raise AssertionError(f"one class must make exactly one min_distances launch, got {launches}")
    return {
        "frames": frames, "generate_s": t_generate, "read_s": t_read, "evaluate_s": t_evaluate,
        "gt_0_yml_sha256": gt_hash, "launches": launches, "scalars": got,
        "worst_gap": worst, "tolerances": EVAL_TOLERANCES,
        "tpu_bf16_sidecar_for_reference_only": {k: sidecar[k] for k in (
            "translation_error_mean_mm", "rotation_error_mean_deg", "hand_error_mean_mm")},
        "card": card,
    }


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not os.path.isdir(os.path.join(HERE, "hmd_ego_pose_tpu_torch")):
        print("chip_smoke.py: the hmd_ego_pose_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from hmd_ego_pose_tpu_torch.kernels import build
    from hmd_ego_pose_tpu_torch.utils.device import resolve_device

    t_all = time.perf_counter()
    dev = resolve_device("cuda")
    card = nvidia_smi()
    emit("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    built = build.build_all()
    emit("build", seconds=time.perf_counter() - t0, built=sorted(built), sources=build.sources())

    kernel = phase_kernel(dev)
    emit("kernel", card=card, **kernel)

    min_dist = phase_min_distances(dev)
    emit("kernel_min_distances", card=card, **min_dist)

    golden, frames, cameras = read_golden()
    predict, outputs, cams, cfg = phase_predict(dev, golden, frames, cameras)
    emit("predict", card=card, **predict)

    serve = phase_serve(dev, golden, frames, outputs, cams, cfg, card)
    emit("serve", **serve)

    evaluate = phase_evaluate(card)
    emit("evaluate", **evaluate)

    leftover = [t.name for t in threading.enumerate()
                if t is not threading.main_thread() and t.is_alive() and not t.daemon]
    if leftover:
        raise RuntimeError(f"threads still alive after shutdown: {leftover}")
    emit("shutdown", threads_alive=[t.name for t in threading.enumerate() if t.is_alive()],
         total_s=time.perf_counter() - t_all)

    launches = {"dequantize": serve["launches"].get("dequantize", 0),
                "min_distances": evaluate["launches"].get("min_distances", 0)}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path never launched the {name} kernel")
    print(json.dumps({"kernels": [
        {
            "name": "dequantize",
            "route": "cuda",
            "source": "hmd_ego_pose_tpu_torch/csrc/dequantize.cu",
            "replaces": "hmd_ego_pose_tpu/ops/quantization.py:64",
            "launches": launches["dequantize"],
            "max_abs_err": kernel["max_abs_err"],
            "ms": kernel["kernel_ms"],
            "plain_ms": kernel["plain_ms"],
            "bound_ms": kernel["bound_ms"],
            "bound_by": kernel["bound_by"],
            "library_ms": kernel["library_ms"],
        },
        {
            "name": "min_distances",
            "route": "cuda",
            "source": "hmd_ego_pose_tpu_torch/csrc/min_distances.cu",
            "replaces": "hmd_ego_pose_tpu/ops/pallas_kernels.py:126",
            "launches": launches["min_distances"],
            "max_abs_err": min_dist["max_abs_err"],
            "ms": min_dist["kernel_ms"],
            "plain_ms": min_dist["plain_ms"],
            "bound_ms": min_dist["bound_ms"],
            "bound_by": min_dist["bound_by"],
            "library_ms": min_dist["library_ms"],
        },
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
