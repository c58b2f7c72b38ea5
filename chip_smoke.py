#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``hmd_ego_pose_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line of its own:

1. device   -- the card's name and power limit (nvidia-smi).
2. build    -- every CUDA kernel of the port built from ``csrc/`` with nvcc,
               one process per source, all at once.
3. kernel   -- the grouped dequantize kernel against its plain PyTorch version
               on the card: a group of one on every int8 leaf of the shipped
               artifact and on seeded odd shapes; the 137 leaves as one group;
               a mixed group (odd shapes, zero columns, half-steps, denormal
               and NaN scales) as one group.  Bit equality required.  Over the
               137 leaves: the group call as the restore makes it (packing,
               uploads, launch), the launch alone on packed buffers already on
               the card, the plain and the one-call PyTorch loops, beside the
               bytes bound.
4. kernel_min_distances -- the ADD-S min-distance kernel against its plain
               version at the evaluation's shape (T=200 pose pairs, P=Q=600)
               and at seeded odd shapes (Q above one staged chunk, P off
               every slice), with duplicate points: bit equality required; a
               NaN point makes its pair's rows NaN; the call (``kernel_ms``)
               and the launch alone (``launch_ms``), plain and
               ``torch.cdist(...).amin`` times at the evaluation's shape,
               beside the operations bound.
5. kernel_target_assign -- the fused target-assignment kernel against its
               plain version ``assign_targets_batch_reference`` on the card:
               the train shape (16 images, 12,276 anchors, K = 1, C = 1), the
               multi-object run's shape (K = 2, C = 2, one object's row
               invalidated), K = 3 padded with two classes, the hazard batch (a padded row after
               a valid row whose best anchor is anchor 0), K = 4 with repeated
               best anchors, images without valid ground truth and anchors
               whose centre lies outside the image, and a data-parallel rank's
               shape (8 images): all five outputs bit-equal,
               one launch count per call; at the train shape the call, the
               launches alone, the plain version's call and device time, the
               host time of one call of each, beside the bytes bound.
6. kernel_quantize -- the grouped int8 quantize kernel against its plain
               version on the card, as groups of one on the 137 dequantized
               int8 leaves of the shipped artifact and on seeded odd shapes (a
               single value and row, C off 32, C = 10, the largest leaf), zero
               columns, exact half-steps, negative zeros and denormals; then
               the 137 leaves as one group and a mixed group (those cases, the
               odd shapes and a NaN column) as one group: int8 values and
               scales bit-equal; quantize_group(dequantize_group(leaves)) must
               give back every stored leaf bit for bit; a column holding NaN
               keeps a NaN scale and touches no other leaf.  Over the 137
               leaves: the group call as the int8 save makes it (packing,
               table upload, launch), the launch alone, the plain and the
               ``torch.quantize_per_channel`` loops (the last with the
               kernel's scales, and the count of int8 values it gets wrong),
               beside the bytes bound.
7. predict  -- restore of ``trained/syn1000_phi0_576ep_handrel_int8.npz`` on the
               card, then ``predict`` (phi-0, 256 px, bf16, score threshold
               0.1) of the six committed golden frames, held to
               ``tests/goldens/handrel_ckpt_expected.npz``
               (``hmd_ego_pose_tpu_torch/eval/golden.py`` states the bounds);
               and the device preprocess of a seeded 300x300 frame, which must
               equal the CPU's bit for bit, with its time and that of a
               1080x1920 frame (to 256 px).
8. serve    -- first the restore alone, three times: its host-to-device copies
               must be one float32 copy (``utils/device.py::pack_transfer``)
               and the int8 group's three (values, scales, table); its seconds.  Then
               the serving path as ``cli serve`` builds it (restore, BN fold,
               engine warm-up) behind a ``PoseServer`` on 127.0.0.1, port 0; a
               ``PoseClient`` sends the six frames as RGB8 and the pose packets
               are held to the goldens.  Then ``cli.start_signaling`` registers
               the server with a loopback node-dss ``SignalingServer``; an
               HMD-side client offers five times, waits for each answer
               (bootstrap ms) and dials the endpoint it names, over which the six frames go as
               I420 and as NV12 (encoded here, BT.601): every answer a
               detection and byte-equal to the server's packet for the RGB8
               frame ``serving/frameio.py`` decodes from that payload, every
               conversion of the server on the compiled path.  Round trip p50
               and max per kind; three I420 requests under
               ``utils/profiler.py::profile_trace``: host and device ms,
               kernels, launch and aten calls, the top ten aten ops by self
               device time, kernels by device time and host rows by self host
               time, each per request.  Kernel launch counts are reset just before
               the engine is built and read just after the phase.
9. evaluate -- ``cli make-synthetic`` writes the 1000-frame, 256 px, seed-0,
               hand-render-v3 set into a temporary directory, in a process
               of its own (``--generate``) started after the device line, so
               that the host's numpy runs while phases 2-8 use the card; the
               phase waits for it; the set's
               ``gt_0.yml`` must hash as the JAX generator's did; then
               ``cli evaluate`` of the shipped artifact on its 200 val frames
               (fp32, unfolded), on the card, with the launch counts reset just
               before and read just after: ``min_distances`` must launch exactly
               once (one class), and every scalar must lie within the stated
               tolerances of ``hmd_ego_pose_tpu_torch/eval/references/handrel_v3_val.json``
               (the JAX package's evaluation, ``scripts/make_eval_reference.py``).
10. train   -- on the same set: first four fixed training steps (augmentation
               and drop-connect off) of ``cli train``'s trainer from the
               artifact, whose six loss terms must lie within the stated
               tolerance of ``hmd_ego_pose_tpu_torch/train/references/
               handrel_v3_train_steps.json`` (the JAX package's steps,
               ``scripts/make_train_reference.py``); then, with the launch
               counts reset just before and read just after, ``cli train``'s
               trainer (``cli.build_trainer``: phi-0, 256 px, fp32, batch 16,
               Adam 1e-4, frozen backbone, oversample 1) for one epoch over the
               600 train frames and validation on the 200 val frames.  Every
               loss finite, ``target_assign`` launched once per step,
               ``dequantize`` once at the restore,
               ``min_distances`` once; the backbone's
               parameters bit-identical and its BN statistics moved; the best
               and ``last`` checkpoints written and restored to the trained
               model, ``last`` with the optimizer's leaves.  Times: step p50 and
               max (synchronised) and its parts, images/s, epoch, validation
               and start-up seconds, and a torch.profiler sample of one more
               step (device time per step, busy share; the sample's time is
               nearly all the profiler's own, so it is kept to one step).
11. train_dp -- data-parallel training: two ranks of ``cli train``'s trainer
               (``cli.build_trainer`` under torchrun's environment, global batch
               16 split 8 + 8) share the one card over gloo, each a subprocess
               of this script (``--train-dp-rank``) started before the train
               phase so that their start-up overlaps it, stepping once it has
               ended, joined with a timeout.
               Four fixed steps (augmentation and drop-connect off) held to
               ``handrel_v3_train_steps.json`` within its tolerance and to the
               train phase's own four steps within 1e-5 relative; then ``fit``
               of one short epoch (4 augmented steps with drop-connect,
               validation on rank 0 only, its metric broadcast, checkpoints by
               rank 0 only): every step finite, the ranks' losses and state
               digests (parameters and BN buffers) bit-identical after every
               step, ``target_assign`` once per step on each rank, ``dequantize``
               once per rank, ``min_distances`` on rank 0 only.  Step p50 against
               the train phase's, the collective calls per step and their share
               of the step.  With two or more cards the fixed steps run again
               over NCCL, one card per rank; with one the line says so.
12. train_multi -- ``cli make-synthetic --num-objects 2`` writes the 400-frame,
               256 px two-object set (fold 0: 240 train, 80 val; in a
               process of its own started beside the v3 set's), whose
               ``gt_0.yml`` must hash as the JAX generator's did; the artifact
               widened to two classes (``models/weights.py::widen_classes``)
               is saved as the start; four fixed steps of ``cli train
               --object-ids 1,2``'s trainer held to
               ``hmd_ego_pose_tpu_torch/train/references/multi2_v3_train_steps.json``;
               then one epoch (oversample 1, augmentation on: the multi-object
               warp) and validation: every loss finite, ``target_assign`` once
               per step, ``min_distances`` twice (once per class), the
               checkpoints written and restored.
13. train_windowed -- the v3 set's 600 train frames with
               ``device_resident_budget_bytes`` of a third of them: three
               windows of 200 frames over one epoch, each window's index rows
               cut to its first 2 steps (6 steps of the epoch's 36),
               ``target_assign`` once per step; the device
               memory held after each window's upload, over the model as
               built, must stay within one window and Adam's moments (one
               window resident at a time), and the peak is reported beside
               the resident run's.
14. train_host -- ``device_augment=False``: four fixed steps of host batches
               (augmentation off) held to ``handrel_v3_train_steps.json``, the
               largest gap between the host-preprocessed and the
               device-preprocessed batch of step 0 per field, then an
               augmented epoch through the host input pipeline (worker
               threads) cut to its first 6 batches (of 37), then 2 steps of
               batches made serially: step times and images/s beside
               the resident run's.
15. train_remat -- ``--no-freeze-backbone``, the same state, batch and
               drop-connect seed through a remat and a plain step: losses
               equal, BN statistics moved once (as the plain step's within
               1e-5 relative), parameters finite and within 2 lr (one Adam
               step); peak memory and step times of three steps of each
               (five until PR 11).
16. export  -- ``cli export --ckpt trained/syn1000_phi0_576ep_handrel_int8.npz
               --quantize-int8`` on the card (phi-0, 256 px, fp32) into the
               temporary directory, with the launch counts reset just before
               and read just after: ``dequantize`` and ``quantize`` once
               each; the program saved, loaded back and verified; the seeded
               input's sha256, the meta JSON and the printed lines as the
               reference's; every golden output within the stated tolerance
               of ``hmd_ego_pose_tpu_torch/export/references/handrel_export.json``
               (the JAX package's export, ``scripts/make_export_reference.py``);
               both weight files with the JAX files' canonical digests; and
               ``weights_int8.npz`` restored on the card equal to the shipped
               artifact.  Seconds of restore, fold, ``torch.export``, save,
               load-and-verify and int8 save, the ``.pt2`` size and the
               fp32/int8 size ratio.
17. cli_rest -- the rest of the CLI, held to
               ``hmd_ego_pose_tpu_torch/eval/references/cli_rest.json`` (the
               JAX package's, ``scripts/make_cli_reference.py``), with the
               launch counts reset just before and read just after: the
               artifact restored on the card with seeded iterative-subnet
               leaves added (``add_iter_leaves``) and saved int8
               (``quantize``), its content digest the JAX package's int8
               save's; ``cli evaluate --iter 1 --save-images-path`` of it on
               the v3 set's 200 val frames, every scalar within the evaluate
               phase's tolerances of the JAX evaluation, one ``det_`` /
               ``samplevis_`` pair per true positive; four fixed training
               steps of ``cli train --iter 1``'s trainer from it within the
               train phase's tolerance; ``cli format-labels`` of 8 seeded
               256 px pickles (``label_pickles``, one corrupt) with the JAX
               output's YAML, split and npy digests and PNG pixel digests,
               read back by ``ColibriDataset``, and ``cli debug`` of it with
               the JAX overlays' pixel digests (PIL's); ``cli parity`` of the
               artifact as a ``module.``-prefixed torch state_dict, fp32 on
               the card, every statistic and head value within 1e-4 of the
               JAX package's at its layer's scale.  ``dequantize`` 3,
               ``quantize`` 1, ``min_distances`` 1, ``target_assign`` 4.
18. shutdown -- server and engine stopped, every thread joined with a timeout.

Then the ``kernels`` JSON line (``target_assign``'s launches summed over the
seven training runs, both data-parallel ranks and the iter-1 steps included,
``min_distances``' over the three evaluations, ``dequantize``'s over serve
and cli_rest, ``quantize``'s over export and cli_rest), the nvidia-smi line,
and as the last line
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
import math
import os
import shutil
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
# the restore of the shipped artifact on the card: one packed float32 copy
# (utils/device.py::pack_transfer) and the int8 group's values, scales and table
RESTORE_UPLOADS = {"pack_transfer/float32": 1, "dequantize_group/values": 1,
                   "dequantize_group/scales": 1, "dequantize/table": 1}
# the odd shapes the kernel must also take: a single row, widths off 32/128
ODD_SHAPES = ((1, 1), (1, 300), (5, 33), (7, 1000), (130, 97), (3, 129))
# (T, P, Q) of the min-distance kernel: the evaluation's shape first, then a
# single point, widths off 128, more Q than one shared-memory chunk (1024),
# and the 1000-point cap the ADD-S stride sets for a dense mesh
MIN_DIST_EVAL_SHAPE = (200, 600, 600)
MIN_DIST_SHAPES = (MIN_DIST_EVAL_SHAPE, (1, 1, 1), (3, 700, 513), (2, 5000, 4999), (64, 1000, 1000))
# the card's evaluation against the JAX package's (fp32 on both sides)
EVAL_TOLERANCES = {"count": 0.0, "accuracy": 0.005, "mm": 0.05, "deg": 0.01}
TRAIN_REFERENCE = os.path.join(HERE, "hmd_ego_pose_tpu_torch", "train", "references",
                               "handrel_v3_train_steps.json")
MULTI_REFERENCE = os.path.join(HERE, "hmd_ego_pose_tpu_torch", "train", "references",
                               "multi2_v3_train_steps.json")
# (B, N, K) of the IoU kernel besides the train step's (16, 12,276 anchors at
# 256 px, 1): four boxes, N off every block size, a single anchor, and more
# boxes than one shared-memory chunk (256)
# the odd shapes the quantize kernel must also take: a single value, a single
# row, C off 32, the largest leaf of the artifact, the smallest C (10)
QUANT_SHAPES = ((1, 1), (1, 1280), (5, 33), (7, 1000), (1152, 320), (3, 10))


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line; ``t_s``: the script's seconds when it ended."""
    print(json.dumps({"phase": phase, **fields, "t_s": time.perf_counter() - T0}), flush=True)


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


def quantize_inputs(seed: int = 7) -> dict:
    """Seeded float32 (R, C) arrays the quantize kernel must take besides the
    artifact's leaves: the odd shapes, then zero columns, values exactly on
    half-steps (round half to even), negative zeros and denormals."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cases = {f"{r}x{c}": rng.normal(0, 0.2, (r, c)).astype(np.float32) for r, c in QUANT_SHAPES}
    zeros = rng.normal(0, 0.2, (6, 40)).astype(np.float32)
    zeros[:, 3], zeros[:, 7] = 0.0, -0.0
    cases["zero_columns"] = zeros
    # column j has scale exactly 2**-(3 + j % 8) (its absmax is 127 steps) and
    # every other value an odd number of half steps: x / scale = k + 0.5 exactly
    steps = 2.0 ** -(3 + np.arange(24) % 8)
    half = (rng.integers(-127, 127, size=(9, 24)) + 0.5) * steps
    half[0] = 127 * steps * np.where(np.arange(24) % 2, 1, -1)
    cases["half_steps"] = half.astype(np.float32)
    negz = rng.normal(0, 0.2, (4, 16)).astype(np.float32)
    negz[rng.random((4, 16)) < 0.4] = -0.0
    negz[:, 5] = -0.0
    cases["negative_zeros"] = negz
    tiny = (rng.normal(0, 1, (5, 9)) * 1e-39).astype(np.float32)  # denormal values
    tiny[:, 1] = np.float32(1e-44) * np.arange(1, 6)  # a few denormal ulps
    tiny[:, 2] = (rng.normal(0, 1, 5) * 1e-20).astype(np.float32)  # absmax below the 1e-12 floor
    tiny[0, 3] = 0.5  # a normal absmax: the column's denormals quantize to 0
    cases["denormals"] = tiny
    return cases


def device_time_ms(fn, reps: int = 50, spin_cycles: int = 50_000_000) -> float:
    """Mean device time of ``fn()`` where the card never waits for the host:
    the calls are queued behind a spin kernel (``torch.cuda._sleep``), and the
    start event must still be pending when the last call has been queued."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    behind_spin = not start.query()
    stop.synchronize()
    if not behind_spin:
        raise AssertionError(f"the spin kernel ended before {reps} calls were queued: raise spin_cycles")
    return start.elapsed_time(stop) / reps


def device_us(event) -> float:
    """Self device time of a torch.profiler ``key_averages()`` row, in microseconds."""
    return float(getattr(event, "self_device_time_total", getattr(event, "self_cuda_time_total", 0.0)) or 0.0)


def on_device(events) -> list:
    """The rows of the card's own events (kernels, copies, sets).  A host-side
    row (an aten op, a runtime call) also carries the device time of the
    kernels it launched, and a range annotated on the device (the optimizer's
    step) spans kernels, so a sum over every row counts kernels twice."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def profiled_device_ms(fn, reps: int = 10):
    """Mean device time of ``fn()`` as torch.profiler sums its kernels and copies,
    for work that synchronises the host inside (where ``device_time_ms`` cannot
    queue it behind a spin kernel); None where the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(device_us(e) for e in on_device(prof.key_averages()))
    return busy / 1e3 / reps if busy else None


def host_ms(fn, reps: int = 20) -> float:
    """Median host time of one ``fn()`` call (what it costs the caller's thread),
    the card idle before each call."""
    import numpy as np
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def mixed_float_group(seed: int = 7) -> dict:
    """The float32 leaves a quantize group must take besides the artifact's,
    launched as one group: ``quantize_inputs()``, a leaf with a NaN column
    (which must touch no other leaf), then the ``ODD_SHAPES``."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    nan = rng.normal(0, 0.2, (5, 33)).astype(np.float32)
    nan[2, 4] = np.nan
    odd = {f"odd {r}x{c}": rng.normal(0, 0.2, (r, c)).astype(np.float32) for r, c in ODD_SHAPES}
    return {**quantize_inputs(seed), "nan_column": nan, **odd}


def mixed_int8_group(seed: int = 0) -> list:
    """(name, values (R, C) int8, scales (C,) float32) of the int8 leaves a
    dequantize group must take besides the artifact's, launched as one group:
    the ``ODD_SHAPES`` with seeded values and scales, then every leaf of
    ``mixed_float_group`` quantized by the plain version (zero columns,
    half-steps, negative zeros, denormal scales, a NaN scale)."""
    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch.ops.quantization import quantize_reference

    rng = np.random.default_rng(seed)
    leaves = [(f"odd {shape}", rng.integers(-127, 128, size=shape, dtype=np.int8),
               rng.uniform(1e-4, 1e-1, size=shape[1]).astype(np.float32)) for shape in ODD_SHAPES]
    for name, x in mixed_float_group().items():
        q, s = quantize_reference(torch.from_numpy(x))
        leaves.append((name, q.numpy(), s.numpy()[0]))
    return leaves


def same_bits(a, b) -> bool:
    """Bit equality of two float32 or int8 tensors (NaN payloads and signed zeros included)."""
    import torch

    return a.shape == b.shape and (torch.equal(a.view(torch.int32), b.view(torch.int32))
                                   if a.dtype == torch.float32 else torch.equal(a, b))


def phase_kernel(dev) -> dict:
    import torch

    from hmd_ego_pose_tpu_torch.kernels import bounds
    from hmd_ego_pose_tpu_torch.ops.quantization import (dequantize, dequantize_group, dequantize_packed,
                                                         dequantize_reference, pack_dequantize_group)

    stored = int8_leaves(ARTIFACT)
    mixed = mixed_int8_group()
    max_err = 0.0
    # the 137 leaves as one group, the mixed group as one group, and every
    # leaf as a group of one (dequantize on tensors already on the card)
    for group_name, group in {"artifact": [(f"leaf {i}", v, s) for i, (v, s) in enumerate(stored)],
                              "mixed": mixed}.items():
        on_card = [(torch.from_numpy(v).to(dev), torch.from_numpy(s).to(dev)) for _, v, s in group]
        got = dequantize_group([(v, s) for _, v, s in group], dev)
        ones = [dequantize(v, s) for v, s in on_card]
        torch.cuda.synchronize()
        for (name, _, _), (v, s), g, one in zip(group, on_card, got, ones):
            want = dequantize_reference(v, s)
            if not (same_bits(g, want) and same_bits(one, want)):
                raise AssertionError(f"dequantize differs from its plain version at {group_name} {name}")
            max_err = max(max_err, *((x - want).nan_to_num(0.0).abs().max().item() for x in (g, one)))
        if group_name == "artifact":
            leaves = on_card

    values, scales, group = pack_dequantize_group(stored)
    packed = (torch.from_numpy(values).to(dev), torch.from_numpy(scales).to(dev))
    table = torch.from_numpy(group.table).to(dev)
    # as the restore makes it: packing, the three uploads and the launch
    ms = cuda_time_ms(lambda: dequantize_group(stored, dev))
    launch_ms = device_time_ms(lambda: dequantize_packed(*packed, group, table))

    def all_leaves(fn):
        return lambda: [fn(v, s) for v, s in leaves]

    plain_ms = cuda_time_ms(all_leaves(dequantize_reference))
    library_ms = cuda_time_ms(all_leaves(lambda v, s: torch.mul(v, s)))  # one call, int8 * f32 -> f32
    n_values = sum(v.numel() for v, _ in leaves)
    n_scales = sum(s.numel() for _, s in leaves)
    return {
        "leaves": len(leaves), "int8_values": n_values, "odd_shapes": [list(s) for s in ODD_SHAPES],
        "mixed_group": [name for name, _, _ in mixed], "blocks": group.blocks,
        "bit_equal": True, "max_abs_err": max_err, "kernel_ms": ms, "launch_ms": launch_ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        **bounds.bound(*bounds.dequantize_work(n_values, n_scales)),
        "kernels": ["dequantize"],
    }


def phase_quantize(dev) -> dict:
    import torch

    from hmd_ego_pose_tpu_torch.kernels import bounds
    from hmd_ego_pose_tpu_torch.ops.quantization import (dequantize_group, pack_quantize_group, quantize,
                                                         quantize_group, quantize_packed, quantize_reference)

    stored = int8_leaves(ARTIFACT)
    leaves = dequantize_group(stored, dev)
    max_err = 0.0

    def hold(name, x, q, sc, nan_column=None):
        nonlocal max_err
        want_q, want_sc = quantize_reference(x)
        torch.cuda.synchronize()
        # a NaN column: NaN scales on both paths; its int8 values are an unspecified cast
        keep = torch.arange(x.shape[1], device=dev) != (-1 if nan_column is None else nan_column)
        nan_held = nan_column is None or bool(sc[0, nan_column].isnan() and want_sc[0, nan_column].isnan())
        if not (nan_held and same_bits(q[:, keep], want_q[:, keep]) and same_bits(sc[:, keep], want_sc[:, keep])):
            raise AssertionError(f"quantize differs from its plain version at {name}: "
                                 f"{int((q[:, keep] != want_q[:, keep]).sum())} int8 values, "
                                 f"{int((sc[:, keep] != want_sc[:, keep]).sum())} scales, NaN held {nan_held}")
        max_err = max(max_err, (q.int() - want_q.int())[:, keep].abs().max().item(),
                      (sc - want_sc)[:, keep].abs().max().item())
        return bool(torch.equal(q, want_q))

    # the 137 leaves as one group, the mixed group (odd shapes, the seeded
    # cases, a NaN column) as one group, and every leaf as a group of one
    mixed = {name: torch.from_numpy(x).to(dev) for name, x in mixed_float_group().items()}
    for group_name, xs in {"artifact": {f"leaf {i}": x for i, x in enumerate(leaves)}, "mixed": mixed}.items():
        got = quantize_group(list(xs.values()))
        for (name, x), (q, sc) in zip(xs.items(), got):
            nan_column = 4 if name == "nan_column" else None
            hold(f"{group_name} group, {name}", x, q, sc, nan_column)
            one_equal = hold(f"{group_name}, {name} as a group of one", x, *quantize(x), nan_column)
            if nan_column is not None:
                nan_column_values_equal = one_equal
        if group_name == "artifact":
            kernel_out = got
    # the shipped artifact is a fixed point: quantize_group(dequantize_group(leaves)) gives back every stored leaf
    for i, ((q, sc), (v, s)) in enumerate(zip(kernel_out, stored)):
        if not (torch.equal(q.cpu(), torch.from_numpy(v)) and torch.equal(sc[0].cpu(), torch.from_numpy(s))):
            raise AssertionError(f"quantize_group(dequantize_group(leaves)) does not give back stored leaf {i}")

    packed, group = pack_quantize_group(leaves, dev)
    table = torch.from_numpy(group.table).to(dev)
    # as the int8 save makes it: the packing, the table's upload and the launch
    ms = cuda_time_ms(lambda: quantize_packed(*pack_quantize_group(leaves, dev)))
    launch_ms = device_time_ms(lambda: quantize_packed(packed, group, table))
    plain_ms = cuda_time_ms(lambda: [quantize_reference(x) for x in leaves])
    # the one-call yardstick: per-channel quantization with the kernel's own scales
    scales = [sc[0].contiguous() for _, sc in kernel_out]
    zeros = [torch.zeros(sc.numel(), dtype=torch.int64, device=dev) for sc in scales]
    library = "torch.quantize_per_channel(x, scales, zeros, 1, torch.qint8) with the kernel's scales"
    try:
        lib_wrong = sum(int((torch.quantize_per_channel(x, sc, z, 1, torch.qint8).int_repr() != q).sum())
                        for x, sc, z, (q, _) in zip(leaves, scales, zeros, kernel_out))
        library_ms = cuda_time_ms(lambda: [torch.quantize_per_channel(x, sc, z, 1, torch.qint8)
                                           for x, sc, z in zip(leaves, scales, zeros)])
        library_error = None
    except (RuntimeError, NotImplementedError) as e:  # the yardstick only: the port never calls it
        lib_wrong, library_ms, library_error = None, None, f"{type(e).__name__}: {e}"[:300]
    n_values = sum(x.numel() for x in leaves)
    cols = sum(x.shape[1] for x in leaves)
    return {
        "leaves": len(leaves), "values": n_values, "columns": cols, "blocks": group.blocks,
        "mixed_group": list(mixed), "bit_equal": True,
        "fixed_point_of_artifact": True, "nan_column_values_equal_plain": nan_column_values_equal,
        "max_abs_err": max_err, "kernel_ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "library": library, "library_int8_values_wrong": lib_wrong,
        "library_error": library_error, **bounds.bound(*bounds.quantize_work(n_values, cols)),
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
    # a NaN predicted point makes every row of its pair NaN and touches no other pair
    g, p = (torch.from_numpy(a).to(dev) for a in point_pairs(rng, 3, 700, 513))
    p[1, 17, 2] = float("nan")
    got, want = min_distances(g, p), min_distances_reference(g, p)
    torch.cuda.synchronize()
    finite = ~want.isnan()
    if not (bool(got[1].isnan().all()) and torch.equal(got.isnan(), want.isnan())
            and torch.equal(got[finite], want[finite])):
        raise AssertionError("min_distances does not carry a NaN point as its plain version does")

    g, p = eval_inputs
    ms = cuda_time_ms(lambda: min_distances(g, p))
    launch_ms = device_time_ms(lambda: min_distances(g, p))
    plain_ms = cuda_time_ms(lambda: min_distances_reference(g, p))
    library_ms = cuda_time_ms(lambda: torch.cdist(g, p).amin(dim=-1))  # the one-call yardstick
    library_dev = (torch.cdist(g, p).amin(dim=-1) - eval_want).abs().max().item()
    return {
        "shapes": checked, "bit_equal": True, "nan_rows_held": True, "max_abs_err": max_err,
        "eval_shape": list(MIN_DIST_EVAL_SHAPE), "kernel_ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "library": "torch.cdist(g, p).amin(-1)",
        "library_max_abs_dev_mm": library_dev,
        **bounds.bound(*bounds.min_distances_work(g.shape[0], g.shape[1], p.shape[1])),
    }


def target_batch(rng, b: int, k: int, num_classes: int, image_size: int = 256):
    """Seeded padded ground truth of B images: (boxes, int32 labels, transformation
    (B, K, 8), coords (B, K, 63), bool valid) as numpy; boxes partly outside the
    image, about 30 % of the rows padding, the first image all valid and the
    second (where B > 1) without valid ground truth."""
    import numpy as np

    xy = rng.uniform(-10, image_size - 8, size=(b, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, image_size / 2, size=(b, k, 2))], axis=-1).astype(np.float32)
    labels = rng.integers(0, num_classes, size=(b, k)).astype(np.int32)
    trans = rng.normal(size=(b, k, 8)).astype(np.float32)
    coords = rng.normal(size=(b, k, 63)).astype(np.float32)
    valid = rng.uniform(size=(b, k)) < 0.7
    valid[0] = True
    if b > 1:
        valid[1] = False
    return boxes, labels, trans, coords, valid


def target_cases(rng) -> dict:
    """name -> (ground truth as numpy, num_classes, image_size) of the target-assignment checks."""
    import numpy as np

    hazard = (np.zeros((2, 2, 4), np.float32), np.zeros((2, 2), np.int32),
              np.arange(32, dtype=np.float32).reshape(2, 2, 8), np.ones((2, 2, 63), np.float32),
              np.array([[True, False], [False, True]]))
    hazard[0][0, 0] = hazard[0][1, 1] = [0, 0, 10, 10]  # best anchor 0 at IoU 0.098; the other row padded
    repeated = target_batch(rng, 3, 4, 1)
    repeated[0][:, 1:] = repeated[0][:, :1]  # four copies of one box: one best anchor for its valid rows
    repeated[0][1] = [0, 0, 10, 10]  # the hazard's box: every row on anchor 0, the last (padded) wins
    repeated[4][:] = [[True, True, False, True], [False, True, True, False], [True, False, True, True]]
    # the multi-object run's shape: two objects a frame, row k of class k, all
    # valid but one object whose mask left the frame (its row kept, valid cleared)
    multi = target_batch(rng, 16, 2, 2)
    multi[1][:] = [0, 1]
    multi[4][:] = True
    multi[4][5, 0] = False
    return {
        "train_k1_c1": (target_batch(rng, 16, 1, 1), 1, 256),
        "train_k2_c2_multi": (multi, 2, 256),
        "k3_padded_c2": (target_batch(rng, 5, 3, 2), 2, 256),
        "hazard": (hazard, 1, 256),
        "k4_repeated_best": (repeated, 1, 256),
        "outside_image_c2": (target_batch(rng, 4, 3, 2, image_size=192), 2, 192),  # 256 px anchors, 192 px image
        "k300_chunked": (target_batch(rng, 2, 300, 1), 1, 256),
        "train_dp_rank_b8": (target_batch(rng, 8, 1, 1), 1, 256),  # a data-parallel rank's 8 of 16 rows
    }


def phase_target_assign(dev) -> dict:
    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES, bounds
    from hmd_ego_pose_tpu_torch.ops.anchors import device_anchors
    from hmd_ego_pose_tpu_torch.ops.target_assign import assign_targets_batch, assign_targets_batch_reference

    cfg = ModelConfig()
    anchors = device_anchors(cfg.image_size, cfg.anchors, dev)[0]
    cases = target_cases(np.random.default_rng(9))
    max_err, checked = 0.0, {}
    LAUNCHES.reset()
    for name, (gt, num_classes, image_size) in cases.items():
        gt = [torch.from_numpy(x).to(dev) for x in gt]
        kw = dict(num_classes=num_classes, image_size=image_size)
        got, want = assign_targets_batch(anchors, *gt, **kw), assign_targets_batch_reference(anchors, *gt, **kw)
        torch.cuda.synchronize()
        for field, a, b in zip(want._fields, got, want):
            if not same_bits(a, b):
                raise AssertionError(f"target_assign differs from its plain version at {name}, {field}: "
                                     f"{int((a != b).sum())} values, max |diff| {(a - b).abs().max().item()}")
            max_err = max(max_err, (a - b).abs().max().item())
        checked[name] = {"batch": gt[0].shape[0], "k": gt[0].shape[1], "classes": num_classes,
                         "image_size": image_size, "positives": int((want.state == 1).sum()),
                         "ignored": int((want.state == -1).sum())}
        if name == "train_k1_c1":
            main = (gt, kw)
        if name == "train_k2_c2_multi":
            multi = (gt, kw)
    if LAUNCHES.get("target_assign") != len(cases):
        raise AssertionError(f"target_assign must count one launch per call, got {LAUNCHES.snapshot()}")
    if checked["hazard"]["positives"] != 1:
        raise AssertionError(f"the hazard batch must keep exactly one forced positive: {checked['hazard']}")
    gt, kw = main

    def kernel():
        return assign_targets_batch(anchors, *gt, **kw)

    def plain():
        return assign_targets_batch_reference(anchors, *gt, **kw)

    b, k = gt[0].shape[:2]
    multi_gt, multi_kw = multi
    k2_launch_ms = device_time_ms(lambda: assign_targets_batch(anchors, *multi_gt, **multi_kw))
    return {
        "cases": checked, "bit_equal": True, "max_abs_err": max_err, "train_shape": [b, anchors.shape[0], k, 1],
        "k2_c2": {"launch_ms": k2_launch_ms, **bounds.bound(*bounds.target_assign_work(
            anchors.shape[0], 2, multi_gt[0].shape[0], 2, multi_gt[2].shape[2], multi_gt[3].shape[2]))},
        "kernel_ms": cuda_time_ms(kernel, reps=200), "launch_ms": device_time_ms(kernel),
        "plain_ms": cuda_time_ms(plain, reps=50), "plain_device_ms": profiled_device_ms(plain),
        "host_ms": {"kernel": host_ms(kernel), "plain": host_ms(plain)}, "library_ms": None,
        "library": "none (no single torch call assigns anchor targets)",
        **bounds.bound(*bounds.target_assign_work(anchors.shape[0], k, b, kw["num_classes"],
                                                  gt[2].shape[2], gt[3].shape[2])),
    }


class TimedStep:
    """Wraps a trainer's step: synchronised times of its parts (batch, augment
    and preprocess; forward + targets + loss; backward; optimizer update) and
    each step's losses, read after the step.  Resident and windowed epochs
    call it, the host pipeline's epochs call its ``host_step``."""

    PARTS = ("prepare", "forward", "backward", "optimizer")

    def __init__(self, step):
        self.step, self.step_ms, self.losses = step, [], []
        self.part_ms = {k: [] for k in self.PARTS}
        update = step.optimizer.step

        def timed_update():
            import torch

            torch.cuda.synchronize()
            t = time.perf_counter()
            update()
            torch.cuda.synchronize()
            self.part_ms["optimizer"].append((time.perf_counter() - t) * 1e3)

        step.optimizer.step = timed_update

    def _timed(self, prepare, generator):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = prepare()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bundle = self.step.losses(batch, generator)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        metrics = self.step.update(bundle)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        self.part_ms["prepare"].append((t1 - t0) * 1e3)
        self.part_ms["forward"].append((t2 - t1) * 1e3)
        self.part_ms["backward"].append((t3 - t2) * 1e3 - self.part_ms["optimizer"][-1])
        self.step_ms.append((t3 - t0) * 1e3)
        self.losses.append({k: float(v) for k, v in metrics.items()})
        return metrics

    def __call__(self, data, idx, draws=None, generator=None):
        return self._timed(lambda: self.step.prepare(data, idx, draws), generator)

    def host_step(self, batch, draws=None, generator=None):
        return self._timed(lambda: self.step.prepare_host(batch, draws), generator)

    def summary(self, batch: int, start: int = 0, stop=None) -> dict:
        """Times of the steps ``start`` .. ``stop``."""
        import numpy as np

        step_ms = np.asarray(self.step_ms[start:stop])
        parts = {k: v[start:stop] for k, v in self.part_ms.items()}
        return {
            "steps": len(step_ms), "step_ms_p50": float(np.percentile(step_ms, 50)),
            "step_ms_max": float(step_ms.max()), "step_ms_first": float(step_ms[0]),
            "images_per_s": batch * len(step_ms) / (step_ms.sum() / 1e3),
            "augment_share": float(np.sum(parts["prepare"]) / step_ms.sum()),
            "part_ms_p50": {k: float(np.percentile(v, 50)) for k, v in parts.items()},
            "loss_first": self.losses[start]["loss"], "loss_last": self.losses[start:stop][-1]["loss"],
        }

    def check_finite(self) -> None:
        import numpy as np

        bad = [i for i, m in enumerate(self.losses) if not all(np.isfinite(v) for v in m.values())]
        if bad:
            raise AssertionError(f"non-finite losses at steps {bad}: {[self.losses[i] for i in bad]}")


def profile_steps(trainer, steps: int = 1) -> dict:
    """Device busy share of a few more (unsynchronised) train steps under
    torch.profiler, and the kernels that take the most device time; None
    where the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rows = trainer.pipeline.epoch_indices(1)[:steps]
    step = trainer.step_fn.step if isinstance(trainer.step_fn, TimedStep) else trainer.step_fn
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for row in rows:
            step(trainer.data, torch.from_numpy(row).to(trainer.device), trainer.draws(), trainer.generator)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = on_device(prof.key_averages())
    busy = sum(device_us(e) for e in events)
    top = sorted(events, key=device_us, reverse=True)[:6]
    return {
        "profiled_steps": len(rows), "wall_ms_per_step": wall_us / 1e3 / len(rows),
        "device_ms_per_step": busy / 1e3 / len(rows) if busy else None,
        "device_busy_share": busy / wall_us if busy else None,
        "top_kernels_ms_per_step": {e.key[:80]: device_us(e) / 1e3 / len(rows) for e in top} if busy else None,
    }


LOSS_TERMS = ("total", "classification", "regression", "rotation", "translation", "hand")


def hold_to_reference(reference: dict, step, what: str) -> list:
    """Runs ``step(s)`` (-> the step's metrics) for each reference step and holds
    its six loss terms to the reference's relative tolerance; returns the
    largest relative gap of each step."""
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES

    terms = dict(zip(LOSS_TERMS, METRIC_NAMES))
    gaps, off = [], []
    for s, want in enumerate(reference["steps"]):
        got = step(s)
        tol = reference["tolerance_rel"]["0" if s == 0 else "3"]
        gap = 0.0
        for term, name in terms.items():
            g = abs(float(got[name]) - want[term]) / max(abs(want[term]), 1e-12)
            gap = max(gap, g)
            if not g <= tol:
                off.append(f"step {s} {term}: card {float(got[name])!r}, JAX {want[term]!r}, rel gap {g:.3g} > {tol}")
        gaps.append(gap)
    if off:
        raise AssertionError(f"the card's {what} losses are off the JAX reference:\n" + "\n".join(off))
    return gaps


def fixed_batch(trainer, s: int):
    """The reference steps' batch s: frames 16 s .. 16 s + 15 of the train split, on the card."""
    import torch

    batch = trainer.config.train.batch_size
    return torch.arange(batch * s, batch * (s + 1), device=trainer.device)


def fit_timed(trainer) -> dict:
    """``trainer.fit()`` with every step timed (``TimedStep``) and validation
    timed; the card synchronised at the end."""
    import torch

    timed = TimedStep(trainer.step_fn)
    trainer.step_fn = timed
    validate, val_s = trainer.validate, []

    def timed_validate(*a, **kw):
        t = time.perf_counter()
        out = validate(*a, **kw)
        val_s.append(time.perf_counter() - t)
        return out

    trainer.validate = timed_validate
    epochs = []
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        best = trainer.fit(on_epoch_end=lambda e, m, r: epochs.append((m, r)))
    torch.cuda.synchronize()
    return {"timed": timed, "best": best, "val_s": val_s, "epochs": epochs, "fit_s": time.perf_counter() - t1}


def check_checkpoints(trainer, best, ckpt_dir: str, steps: int, work: str) -> dict:
    """The best and ``last`` checkpoints written, each restoring to the trained
    model, ``last`` with the optimizer's leaves and step count."""
    import torch

    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
    from hmd_ego_pose_tpu_torch.models.weights import from_jax_params
    from hmd_ego_pose_tpu_torch.train.checkpoint import restore_checkpoint, restore_opt_leaves

    last = os.path.join(ckpt_dir, "last.npz")
    if best is None or not os.path.exists(best) or not os.path.exists(last):
        raise AssertionError(f"checkpoints not written: best {best}, last exists {os.path.exists(last)}")
    state = trainer.model.state_dict()
    restored = {}
    for name, path in (("best", best), ("last", last)):
        params, bn_state, meta = restore_checkpoint(path, trainer.device)
        model = HMDEgoPose(trainer.config.model).to(trainer.device)
        model.load_state_dict(from_jax_params(params, bn_state, trainer.config.model), strict=True)
        if not all(torch.equal(model.state_dict()[k].cpu(), v.cpu()) for k, v in state.items()):
            raise AssertionError(f"the {name} checkpoint does not restore the trained model")
        restored[name] = {"path": os.path.relpath(path, work), "metric": meta.get("metric")}
    opt = restore_opt_leaves(last)
    if opt is None or len(opt) != trainer.optimizer.num_leaves():
        raise AssertionError(f"last.npz holds {None if opt is None else len(opt)} opt leaves, "
                             f"the optimizer {trainer.optimizer.num_leaves()}")
    if int(opt[0].item()) != steps:
        raise AssertionError(f"the saved optimizer count is {opt[0]}, not {steps}")
    return {"checkpoints": restored, "opt_leaves": len(opt)}


def phase_train(card: str, data: str, work: str) -> dict:
    import torch

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES
    from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

    with open(TRAIN_REFERENCE) as f:
        reference = json.load(f)
    args = cli.build_parser().parse_args(["train", "--dataset-path", data, "--ckpt", ARTIFACT, "--epo", "1"])
    quiet = io.StringIO()

    # 1. reference check: four steps from the artifact, augmentation and
    # drop-connect off, fixed batches, against the JAX package's losses
    with contextlib.redirect_stdout(quiet):
        ref_trainer = cli.build_trainer(args, logger=MetricLogger(os.path.join(work, "runs"), stdout=False),
                                        checkpoint_dir=os.path.join(work, "ref_ckpt"))
    ref_steps = []

    def ref_step(s):
        metrics = ref_trainer.step_fn(ref_trainer.data, fixed_batch(ref_trainer, s), None, None)
        ref_steps.append({k: float(v) for k, v in metrics.items()})
        return metrics

    ref_gaps = hold_to_reference(reference, ref_step, "training")
    del ref_trainer
    torch.cuda.empty_cache()

    # 2. the main path: cli train's trainer, one epoch over the 600 train frames
    # (oversample 1: 37 steps of 16), validation on the 200 val frames, the checkpoints
    ckpt_dir = os.path.join(work, "ckpt")
    LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(quiet):
        trainer = cli.build_trainer(args, logger=MetricLogger(os.path.join(work, "runs"), stdout=False),
                                    oversample=1, checkpoint_dir=ckpt_dir)
    torch.cuda.synchronize()
    t_startup = time.perf_counter() - t0
    launches_restore = LAUNCHES.snapshot()
    backbone = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()
                if k.startswith("backbone_net.")}
    run = fit_timed(trainer)
    launches = LAUNCHES.snapshot()

    timed = run["timed"]
    steps, batch = len(timed.step_ms), trainer.config.train.batch_size
    frames = len(trainer.train_dataset)
    if trainer.path != "resident" or steps != frames // batch:
        raise AssertionError(f"{steps} steps for {frames} frames at batch {batch} on the {trainer.path} path")
    timed.check_finite()
    if launches.get("target_assign", 0) != steps:
        raise AssertionError(f"target_assign must launch once per step ({steps}), got {launches}")
    if launches_restore.get("dequantize", 0) != 1 or launches.get("dequantize", 0) != 1:
        raise AssertionError(f"the restore must launch dequantize once, got {launches_restore}")
    if launches.get("min_distances", 0) != 1:
        raise AssertionError(f"validation must launch min_distances once, got {launches}")
    state = trainer.model.state_dict()
    moved = [k for k, v in backbone.items() if not torch.equal(state[k], v)]
    params_moved = [k for k in moved if not k.endswith(("running_mean", "running_var"))]
    if params_moved:
        raise AssertionError(f"frozen backbone parameters changed: {params_moved[:5]}")
    stats_moved = [k for k in moved if k.endswith(("running_mean", "running_var"))]
    if not stats_moved:
        raise AssertionError("the backbone's BN running statistics did not move in training mode")
    saved = check_checkpoints(trainer, run["best"], ckpt_dir, steps, work)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    t_profile = time.perf_counter()
    profile = profile_steps(trainer)
    profile["profile_s"] = time.perf_counter() - t_profile
    train_metrics, result = run["epochs"][-1]
    return {
        "reference_max_rel_gap": ref_gaps, "reference_tolerance_rel": reference["tolerance_rel"],
        "reference_steps": ref_steps, **timed.summary(batch), "batch": batch, "frames": frames,
        "val_frames": len(trainer.val_dataset),
        "startup_s": t_startup, "fit_s": run["fit_s"], "epoch_s": train_metrics["epoch_seconds"],
        "validate_s": run["val_s"][0] if run["val_s"] else None, "profile": profile,
        "epoch_means": {k: train_metrics[k] for k in METRIC_NAMES},
        "val_mixed_point_distance_mean_mm": result.scalars()["mixed_point_distance_mean_mm"],
        "launches": launches, "backbone_stats_moved": len(stats_moved), **saved,
        "peak_mem_gb": peak_gb, "card": card,
    }


# train_dp's augmented epoch, cut to keep the script's time
DP_AUG_STEPS = 4
# the windowed and host variants' steps, cut from a full epoch (36-37 steps)
# to keep the script's time: each still runs the trainer's epoch code, the
# windowed one over all three windows
VARIANT_STEPS = 6
DP_RANK_TIMEOUT_S = 240


def train_dp_rank(mode: str, data: str, work: str, go: str = "") -> dict:
    """One data-parallel rank (run as ``chip_smoke.py --train-dp-rank MODE DATA WORK
    [GO]`` under torchrun's environment): ``cli.build_trainer`` on the v3 set at
    global batch 16, then, once the file ``GO`` exists (the caller's signal that
    the card is free), four fixed steps (augmentation and drop-connect off) on its rows
    of the reference batches, then (mode ``gloo``) ``fit`` of one short epoch:
    ``DP_AUG_STEPS`` augmented steps with drop-connect, validation on rank 0,
    the metric broadcast, checkpoints by rank 0.  Mode ``gloo``: the ranks
    share card 0; ``nccl``: rank r on card r, the fixed steps only."""
    import torch
    import torch.distributed as dist

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.parallel import distributed
    from hmd_ego_pose_tpu_torch.parallel.mesh import shard_batch, state_digest
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES
    from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

    class DigestStep(TimedStep):
        """A timed step that records the state digest after each step."""

        def __init__(self, step, model):
            super().__init__(step)
            self.model, self.digests = model, []

        def _timed(self, prepare, generator):
            metrics = super()._timed(prepare, generator)
            self.digests.append(state_digest(self.model))
            return metrics

    shared = mode == "gloo"
    device = "cuda:0" if shared else f"cuda:{os.environ['LOCAL_RANK']}"
    distributed.initialize(device, shared_device=shared, timeout=120.0)
    rank = dist.get_rank()
    args = cli.build_parser().parse_args(["train", "--dataset-path", data, "--ckpt", ARTIFACT, "--epo", "1",
                                          "--device", device])
    LAUNCHES.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        logger = MetricLogger(os.path.join(work, "runs"), stdout=False) if rank == 0 else None
        trainer = cli.build_trainer(args, logger=logger, checkpoint_dir=os.path.join(work, "ckpt"))
    torch.cuda.synchronize()
    out = {"rank": rank, "world": trainer.mesh.world, "backend": dist.get_backend(), "device": str(trainer.device),
           "rows": [trainer.rows.start, trainer.rows.stop], "startup_s": time.perf_counter() - t0,
           "restore_launches": LAUNCHES.snapshot()}
    t0 = time.perf_counter()
    while go and not os.path.exists(go):
        if time.perf_counter() - t0 > DP_RANK_TIMEOUT_S:
            raise TimeoutError(f"rank {rank}: no {go} after {DP_RANK_TIMEOUT_S} s")
        time.sleep(0.05)
    out["waited_s"] = time.perf_counter() - t0
    fixed, digests = [], []
    for s in range(4):
        metrics = trainer.step_fn(trainer.data, shard_batch(trainer.mesh, fixed_batch(trainer, s)), None, None)
        fixed.append({k: float(metrics[k]) for k in METRIC_NAMES})
        digests.append(state_digest(trainer.model))
    out.update(fixed=fixed, fixed_digests=digests)
    if shared:
        # fit runs the trainer's own epoch code, its epoch cut to the first
        # DP_AUG_STEPS index rows the sampler draws
        timed = DigestStep(trainer.step_fn, trainer.model)
        trainer.step_fn = timed
        epoch_indices = trainer.pipeline.epoch_indices
        trainer.pipeline.epoch_indices = lambda oversample=1: epoch_indices(oversample)[:DP_AUG_STEPS]
        epochs = []
        trainer.mesh.stats.reset()
        t = time.perf_counter()
        best = trainer.fit(epochs=1, on_epoch_end=lambda epoch, metrics, result: epochs.append(metrics))
        fit_s = time.perf_counter() - t
        if (trainer.path != "resident" or [m["steps"] for m in epochs] != [DP_AUG_STEPS]
                or len(timed.step_ms) != DP_AUG_STEPS):
            raise AssertionError(f"rank {rank}: {len(timed.step_ms)} steps on the {trainer.path} path, "
                                 f"the epoch says {epochs}")
        stats = trainer.mesh.stats.snapshot()
        step_s = sum(timed.step_ms) / 1e3
        step_kinds = ("bn", "bn_backward", "grads", "metrics")  # a step's collectives
        collective_s = sum(v for k, v in stats["seconds"].items() if k in step_kinds)
        timed.check_finite()
        out.update(
            augmented=timed.summary(trainer.config.train.batch_size), augmented_losses=timed.losses,
            augmented_digests=timed.digests, fit_s=fit_s, best=best, lr=trainer.optimizer.learning_rate,
            plateau=dict(vars(trainer.scheduler)),
            collective_calls_per_step={k: v / DP_AUG_STEPS for k, v in stats["calls"].items() if k in step_kinds},
            collective_share_of_step=collective_s / step_s, collective_ms_per_step=collective_s * 1e3 / DP_AUG_STEPS,
            epoch_means={k: epochs[0][k] for k in METRIC_NAMES},
            files=sorted(os.path.relpath(os.path.join(r, f), work) for r, _, fs in os.walk(work) for f in fs))
    out["launches"] = LAUNCHES.snapshot()
    dist.destroy_process_group()
    return out


def start_dp_ranks(mode: str, data: str, work: str, go: str = "") -> list:
    """Two ranks of ``train_dp_rank`` as subprocesses of this script (a free
    127.0.0.1 port, torchrun's environment), waiting for ``go`` after their
    start-up if it is given."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(2):
        rank_work = os.path.join(work, f"{mode}_rank{rank}")
        os.makedirs(rank_work, exist_ok=True)
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank), PYTHONPATH=HERE)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--train-dp-rank", mode, data,
                                       rank_work, go], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, cwd=rank_work))
    return procs


def join_dp_ranks(mode: str, procs: list) -> list:
    """Joins ``start_dp_ranks``' ranks, each within ``DP_RANK_TIMEOUT_S`` from
    now and killed past it; a rank that fails or times out raises.  Returns
    each rank's JSON line."""
    deadline, results, failed = time.monotonic() + DP_RANK_TIMEOUT_S, [], []
    try:
        for rank, proc in enumerate(procs):
            try:
                stdout, stderr = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
                failed.append(f"rank {rank} timed out after {DP_RANK_TIMEOUT_S} s:\n{stderr[-3000:]}")
                continue
            if proc.returncode != 0:
                failed.append(f"rank {rank} exited {proc.returncode}:\n{stderr[-3000:]}")
                continue
            results.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    if failed:
        raise AssertionError(f"data-parallel ranks ({mode}) failed:\n" + "\n".join(failed))
    return results


def hold_dp_fixed(ranks: list, reference: dict, single_steps: list) -> dict:
    """The fixed steps: the ranks' logged losses equal, each step's state digest
    the same on both ranks, the six terms within the reference's tolerance of
    the JAX package's and within 1e-5 relative of the single-process steps."""
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES

    zero, one = ranks
    if zero["fixed"] != one["fixed"] or zero["fixed_digests"] != one["fixed_digests"]:
        raise AssertionError("the ranks' fixed steps differ: losses or parameters and BN buffers not bit-identical")
    steps = iter(zero["fixed"])
    ref_gaps = hold_to_reference(reference, lambda s: next(steps), "data-parallel training")
    terms = dict(zip(LOSS_TERMS, METRIC_NAMES))
    single_gap = max(abs(got[name] - want[name]) / max(abs(want[name]), 1e-12)
                     for got, want in zip(zero["fixed"], single_steps) for name in terms.values())
    if not single_gap <= 1e-5:
        raise AssertionError(f"the data-parallel steps are {single_gap:.3g} relative off the single-process "
                             f"steps (> 1e-5): {zero['fixed']} against {single_steps}")
    return {"reference_max_rel_gap": ref_gaps, "single_process_max_rel_gap": single_gap}


def phase_train_dp(card: str, data: str, work: str, train: dict, procs: list, go: str) -> dict:
    """Data-parallel training: two gloo ranks sharing the one card (each a
    subprocess running ``train_dp_rank``, started before the train phase so
    that their start-up overlaps it), global batch 16 split 8 + 8: ``go``
    lets them step."""
    import torch

    with open(TRAIN_REFERENCE) as f:
        reference = json.load(f)
    t0 = time.perf_counter()
    with open(go, "w"):
        pass
    ranks = join_dp_ranks("gloo", procs)
    run_s = time.perf_counter() - t0
    zero, one = ranks
    held = hold_dp_fixed(ranks, reference, train["reference_steps"])
    if (zero["augmented_digests"] != one["augmented_digests"] or zero["augmented_losses"] != one["augmented_losses"]
            or zero["epoch_means"] != one["epoch_means"]):
        raise AssertionError("the ranks' augmented steps differ: not bit-identical")
    if zero["backend"] != "gloo" or [r["rows"] for r in ranks] != [[0, 8], [8, 16]]:
        raise AssertionError(f"expected two gloo ranks of 8 rows: {[(r['backend'], r['rows']) for r in ranks]}")
    if (zero["lr"] != one["lr"] or zero["plateau"] != one["plateau"]
            or os.path.basename(zero["best"]) != os.path.basename(one["best"])):
        raise AssertionError(f"the ranks' plateau or best checkpoint differ: {zero['plateau']}, {one['plateau']}")
    if one["files"] or os.path.join("ckpt", "last.npz") not in zero["files"]:
        raise AssertionError(f"only rank 0 writes checkpoints: rank 0 {zero['files']}, rank 1 {one['files']}")
    steps = 4 + DP_AUG_STEPS
    for r in ranks:
        if r["launches"].get("target_assign", 0) != steps or r["restore_launches"].get("dequantize", 0) != 1:
            raise AssertionError(f"rank {r['rank']}: target_assign must launch once per step ({steps}) and "
                                 f"dequantize once at the restore: {r['launches']}")
    if zero["launches"].get("min_distances", 0) != 1 or one["launches"].get("min_distances", 0) != 0:
        raise AssertionError(f"validation must run on rank 0 only: {[r['launches'] for r in ranks]}")
    nccl = "not run: 1 card"
    if torch.cuda.device_count() >= 2:
        nccl_ranks = join_dp_ranks("nccl", start_dp_ranks("nccl", data, os.path.join(work, "dp_nccl")))
        if nccl_ranks[0]["backend"] != "nccl" or nccl_ranks[1]["device"] != "cuda:1":
            raise AssertionError(f"not NCCL across cards: {[(r['backend'], r['device']) for r in nccl_ranks]}")
        nccl = hold_dp_fixed(nccl_ranks, reference, train["reference_steps"])
    aug = zero["augmented"]
    return {
        **held, "ranks": 2, "backend": "gloo", "shared_card": True, "batch_per_rank": 8,
        "augmented": aug, "single_process_step_ms_p50": train["step_ms_p50"],
        "step_vs_single_process": aug["step_ms_p50"] / train["step_ms_p50"],
        "collective_calls_per_step": zero["collective_calls_per_step"],
        "collective_ms_per_step": zero["collective_ms_per_step"],
        "collective_share_of_step": zero["collective_share_of_step"],
        "fit_s": zero["fit_s"], "startup_s": [r["startup_s"] for r in ranks], "ranks_s": run_s,
        "waited_s": [r["waited_s"] for r in ranks],
        "val_metric_broadcast": zero["plateau"]["best"],
        "launches": {"target_assign": sum(r["launches"].get("target_assign", 0) for r in ranks)},
        "launches_per_rank": [r["launches"] for r in ranks], "nccl": nccl, "card": card,
    }


def phase_train_multi(card: str, work: str, generation: subprocess.Popen) -> dict:
    """Two objects a frame: the 400-frame two-object set, the artifact widened to
    two classes, four reference steps, then an epoch through cli train's
    trainer with validation once per class."""
    import torch

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.models.weights import widen_classes
    from hmd_ego_pose_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

    with open(MULTI_REFERENCE) as f:
        reference = json.load(f)
    data = os.path.join(work, MULTI_SET[0])
    generated = finish_generation(generation)
    with open(os.path.join(data, "data", "01", "gt_0.yml"), "rb") as f:
        gt_hash = hashlib.sha256(f.read()).hexdigest()
    if gt_hash != reference["gt_0_yml_sha256"]:
        raise AssertionError(f"the port's two-object gt_0.yml hashes {gt_hash}, the JAX generator's "
                             f"{reference['gt_0_yml_sha256']}")
    params, bn_state, meta = restore_checkpoint(ARTIFACT, "cpu")
    start = save_checkpoint(work, "multi2_start", widen_classes(params, 2), bn_state,
                            metadata={"hand_relative": meta["hand_relative"]})
    args = cli.build_parser().parse_args(["train", "--dataset-path", data, "--ckpt", start, "--epo", "1",
                                          "--object-ids", "1,2"])
    logger = MetricLogger(os.path.join(work, "runs"), stdout=False)
    with contextlib.redirect_stdout(io.StringIO()):
        ref_trainer = cli.build_trainer(args, logger=logger, checkpoint_dir=os.path.join(work, "multi_ref_ckpt"))
    ref_gaps = hold_to_reference(
        reference, lambda s: ref_trainer.step_fn(ref_trainer.data, fixed_batch(ref_trainer, s), None, None),
        "multi-object training")
    del ref_trainer
    torch.cuda.empty_cache()

    ckpt_dir = os.path.join(work, "multi_ckpt")
    LAUNCHES.reset()
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = cli.build_trainer(args, logger=logger, oversample=1, checkpoint_dir=ckpt_dir)
    run = fit_timed(trainer)
    launches = LAUNCHES.snapshot()
    timed, batch = run["timed"], trainer.config.train.batch_size
    steps = len(timed.step_ms)
    if trainer.config.model.num_classes != 2 or trainer.config.data.max_objects != 2:
        raise AssertionError(f"not a two-class, two-object run: {trainer.config.model}, {trainer.config.data}")
    if steps != len(trainer.train_dataset) // batch:
        raise AssertionError(f"{steps} steps for {len(trainer.train_dataset)} frames")
    timed.check_finite()
    if launches.get("target_assign", 0) != steps:
        raise AssertionError(f"target_assign must launch once per step ({steps}), got {launches}")
    if launches.get("min_distances", 0) != 2:
        raise AssertionError(f"a two-class validation must launch min_distances twice, got {launches}")
    saved = check_checkpoints(trainer, run["best"], ckpt_dir, steps, work)
    _, result = run["epochs"][-1]
    return {
        "reference_max_rel_gap": ref_gaps, "reference_tolerance_rel": reference["tolerance_rel"],
        "gt_0_yml_sha256": gt_hash, **generated, **timed.summary(batch),
        "frames": len(trainer.train_dataset), "val_frames": len(trainer.val_dataset), "fit_s": run["fit_s"],
        "validate_s": run["val_s"][0] if run["val_s"] else None,
        "val_per_class": {c: {k: r.scalars()[k] for k in ("num_matched", "mean_ap", "mixed_point_distance_mean_mm")}
                          for c, r in sorted(result.per_class.items())},
        "launches": launches, **saved, "card": card,
    }


def phase_train_windowed(card: str, data: str, work: str, resident_peak_gb: float) -> dict:
    """The 600 train frames with a budget of a third of them (200 frames): three
    windows, one resident at a time."""
    import torch

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
    from hmd_ego_pose_tpu_torch.data.device_dataset import build_host_cache
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.train import trainer as trainer_module
    from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

    cache = build_host_cache(ColibriDataset(data, 0, 1, "train"), 1)
    per_frame, window = cache.bytes_per_frame(), cache.frames.shape[0] // 3
    del cache
    args = cli.build_parser().parse_args(["train", "--dataset-path", data, "--ckpt", ARTIFACT, "--epo", "1"])
    LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = cli.build_trainer(args, logger=MetricLogger(os.path.join(work, "runs"), stdout=False),
                                    data_overrides={"device_resident_budget_bytes": window * per_frame + 1024},
                                    oversample=1, checkpoint_dir=os.path.join(work, "windowed_ckpt"))
    if trainer.path != "windowed" or trainer.window_frames != window:
        raise AssertionError(f"expected windows of {window} frames, got the {trainer.path} path "
                             f"({trainer.window_frames} frames)")
    base = torch.cuda.memory_allocated()
    resident, upload = [], trainer_module.upload_window

    def one_window(cache, rows, device):
        if trainer.data is not None:
            raise AssertionError("a window was uploaded while the previous one was still held")
        out = upload(cache, rows, device)
        torch.cuda.synchronize()
        resident.append(torch.cuda.memory_allocated() - base)
        return out

    timed = TimedStep(trainer.step_fn)
    trainer.step_fn = timed
    plan = trainer_module.window_plan
    per_window = VARIANT_STEPS // 3

    def short_plan(*a, **kw):  # each window's index rows cut to its first per_window steps
        return [(rows, idxs[:per_window]) for rows, idxs in plan(*a, **kw)]

    trainer_module.upload_window, trainer_module.window_plan = one_window, short_plan
    try:
        t0 = time.perf_counter()
        metrics = trainer.train_epoch(0)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
    finally:
        trainer_module.upload_window, trainer_module.window_plan = upload, plan
    launches = LAUNCHES.snapshot()
    batch, steps = trainer.config.train.batch_size, len(timed.step_ms)
    window_bytes = window * per_frame
    if trainer.windows != [window] * 3 or not steps == metrics["steps"] == 3 * per_window:
        raise AssertionError(f"windows {trainer.windows}, {steps} steps, epoch says {metrics['steps']}")
    timed.check_finite()
    if launches.get("target_assign", 0) != steps:
        raise AssertionError(f"target_assign must launch once per step ({steps}), got {launches}")
    # over the model as built: one window, and Adam's two moments from the first step on
    adam_bytes = 2 * sum(p.numel() * p.element_size() for p in trainer.optimizer.params)
    if max(resident) > window_bytes + adam_bytes + (1 << 20):
        raise AssertionError(f"more than one window resident: {resident} bytes over the model's state, "
                             f"a window is {window_bytes}, Adam's moments {adam_bytes}")
    return {
        **timed.summary(batch), "windows": trainer.windows, "window_mb": window_bytes / 1e6,
        "split_mb": per_frame * len(trainer.train_dataset) / 1e6, "epoch_s": epoch_s,
        "data_resident_mb_after_each_upload": [r / 1e6 for r in resident], "adam_moments_mb": adam_bytes / 1e6,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30, "resident_run_peak_mem_gb": resident_peak_gb,
        "launches": launches, "card": card,
    }


def phase_train_host(card: str, data: str, work: str, resident: dict) -> dict:
    """device_augment=False: the host input pipeline.  Four fixed steps
    (augmentation off) held to the resident path's JAX reference, then an
    augmented epoch cut to ``VARIANT_STEPS`` batches (4 worker threads), then
    four steps whose batches are made in this thread."""
    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

    with open(TRAIN_REFERENCE) as f:
        reference = json.load(f)
    args = cli.build_parser().parse_args(["train", "--dataset-path", data, "--ckpt", ARTIFACT, "--epo", "1"])
    logger = MetricLogger(os.path.join(work, "runs"), stdout=False)
    off = {"device_augment": False, "use_6dof_augmentation": False, "use_colorspace_augmentation": False}
    with contextlib.redirect_stdout(io.StringIO()):
        ref_trainer = cli.build_trainer(args, logger=logger, data_overrides=off,
                                        checkpoint_dir=os.path.join(work, "host_ref_ckpt"))
        device_trainer = cli.build_trainer(args, logger=logger, checkpoint_dir=os.path.join(work, "host_ref_ckpt"))
    batch = ref_trainer.config.train.batch_size
    seeds = np.zeros(batch, np.int64)

    def host_batch(s):
        return ref_trainer.pipeline._make_batch(np.arange(batch * s, batch * (s + 1)), seeds)

    # the same batch from the host preprocess and from the device one
    host = ref_trainer.step_fn.prepare_host(host_batch(0))
    dev = device_trainer.step_fn.prepare(device_trainer.data, fixed_batch(device_trainer, 0), None)
    batch_gap = {name: float((a.double() - b.double()).abs().max()) for name, a, b in zip(host._fields, host, dev)}
    del device_trainer
    gaps = hold_to_reference(reference, lambda s: ref_trainer.step_fn.host_step(host_batch(s)),
                             "host-pipeline training")
    del ref_trainer
    torch.cuda.empty_cache()

    LAUNCHES.reset()
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = cli.build_trainer(args, logger=logger, data_overrides={"device_augment": False}, oversample=1,
                                    checkpoint_dir=os.path.join(work, "host_ckpt"))
    timed = TimedStep(trainer.step_fn)
    trainer.step_fn = timed
    # the epoch cut to its first VARIANT_STEPS batches (the sampler's rows as drawn)
    epoch_indices = trainer.pipeline.epoch_indices
    trainer.pipeline.epoch_indices = lambda oversample=1: epoch_indices(oversample)[:VARIANT_STEPS]
    t0 = time.perf_counter()
    metrics = trainer.train_epoch(0)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    trainer.pipeline.epoch_indices = epoch_indices
    launches = LAUNCHES.snapshot()
    steps = len(timed.step_ms)
    if trainer.path != "host" or not steps == metrics["steps"] == VARIANT_STEPS:
        raise AssertionError(f"{steps} host steps on the {trainer.path} path, epoch says {metrics['steps']}")
    timed.check_finite()
    if launches.get("target_assign", 0) != steps:
        raise AssertionError(f"target_assign must launch once per step ({steps}), got {launches}")
    # two more steps with each batch made in this thread before its step: the
    # step's parts with no worker thread running beside the launches, and the
    # host's time to make one augmented batch
    serial = trainer.pipeline.batches(oversample=1, num_workers=1)
    make_ms = []
    for _ in range(2):
        t = time.perf_counter()
        made = next(serial)
        make_ms.append((time.perf_counter() - t) * 1e3)
        timed.host_step(made, None, trainer.generator)
    serial.close()
    timed.check_finite()
    return {
        "reference_max_rel_gap": gaps, "reference_tolerance_rel": reference["tolerance_rel"],
        "host_vs_device_batch_max_abs": batch_gap, **timed.summary(batch, 0, steps), "epoch_s": epoch_s,
        "serial": {**timed.summary(batch, steps), "make_batch_ms_p50": float(np.median(make_ms))},
        "workers": trainer.config.data.num_workers,
        "resident_step_ms_p50": resident["step_ms_p50"], "resident_images_per_s": resident["images_per_s"],
        "launches": launches, "card": card,
    }


def phase_train_remat(card: str, data: str, work: str) -> dict:
    """remat_backbone with the backbone trainable: the same state, batch and
    drop-connect seed through a remat and a plain step; then two more steps
    of each for their times."""
    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

    args = cli.build_parser().parse_args(["train", "--dataset-path", data, "--ckpt", ARTIFACT, "--epo", "1",
                                          "--no-freeze-backbone"])
    off = {"use_6dof_augmentation": False, "use_colorspace_augmentation": False}
    runs, states, lr = {}, {}, None
    LAUNCHES.reset()
    for remat in (True, False):
        with contextlib.redirect_stdout(io.StringIO()):
            trainer = cli.build_trainer(args, logger=MetricLogger(os.path.join(work, "runs"), stdout=False),
                                        data_overrides=off, model_overrides={"remat_backbone": remat},
                                        checkpoint_dir=os.path.join(work, "remat_ckpt"))
        lr = trainer.config.train.learning_rate
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        ms, peaks, later = [], [], []
        for s in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = trainer.step_fn(trainer.data, fixed_batch(trainer, s), None, torch.Generator().manual_seed(5))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            if s == 0:
                first = {k: float(v) for k, v in m.items()}
                states[remat] = ({k: v.clone() for k, v in trainer.model.state_dict().items()}, first)
            else:
                later.append(float(m["loss"]))
        runs["remat" if remat else "plain"] = {"step_ms": ms, "step_ms_p50_after_first": float(np.median(ms[1:])),
                                               "peak_mem_gb_first_step": peaks[0],
                                               "peak_mem_gb": max(peaks), "losses_first": first,
                                               "losses_later": later}
        del trainer
        torch.cuda.empty_cache()
    launches = LAUNCHES.snapshot()
    (r_state, r_loss), (p_state, p_loss) = states[True], states[False]
    if r_loss != p_loss:
        raise AssertionError(f"remat changed the step's losses: {r_loss} against {p_loss}")
    stats = [k for k in p_state if k.endswith(("running_mean", "running_var"))]
    moved = [k for k in stats if not torch.equal(p_state[k], before[k])]
    stat_gap = max(float((r_state[k] - p_state[k]).abs().max() / (p_state[k].abs().max() + 1e-12)) for k in stats)
    # a second move would put each statistic m (1 - m) (batch - running) further, ~1e-2 relative
    if not moved or stat_gap > 1e-5:
        raise AssertionError(f"the BN statistics must move once, as without remat: {len(moved)} moved, "
                             f"largest relative gap {stat_gap}")
    params = [k for k in p_state if k not in stats]
    bad = [k for k in params if not (torch.isfinite(r_state[k]).all() and torch.isfinite(p_state[k]).all())]
    if bad:
        raise AssertionError(f"non-finite parameters after one step: {bad[:5]}")
    param_gap = max(float((r_state[k] - p_state[k]).abs().max()) for k in params)
    # one Adam step moves an element by at most lr: two cuDNN backwards that
    # differ in a noise-level gradient's sign put it at most 2 lr apart
    if not param_gap <= 2 * lr + 1e-6:
        raise AssertionError(f"remat and plain steps' parameters differ by {param_gap} > 2 lr")
    later = [v for run in runs.values() for v in run["losses_later"]]
    if not all(math.isfinite(v) for v in later):
        raise AssertionError(f"non-finite losses in the later steps: {later}")
    backbone_moved = any(not torch.equal(p_state[k], before[k]) for k in params if k.startswith("backbone_net."))
    if not backbone_moved:
        raise AssertionError("the backbone did not train (--no-freeze-backbone)")
    if launches.get("target_assign", 0) != 6:
        raise AssertionError(f"target_assign must launch once per step (6), got {launches}")
    return {
        **runs, "losses_equal": True, "bn_stats_moved": len(moved), "bn_stat_max_rel_gap": stat_gap,
        "param_max_abs_gap": param_gap,
        "params_differing": sum(int((r_state[k] != p_state[k]).sum()) for k in params),
        "launches": launches, "card": card,
    }


def _leaves(tree, prefix: str = ""):
    """(path, leaf) of a nested dict / list / tuple tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}{i}/")]
    return [(prefix, tree)]


@contextlib.contextmanager
def timed_calls(targets):
    """Within the block, every call of ``getattr(owner, name)`` for each
    (owner, name, key) of ``targets`` is timed, the card synchronised after
    it, its seconds appended to ``seconds[key]``; the functions are put back
    after the block.  Yields ``seconds``."""
    import torch

    seconds, saved = {}, []
    for owner, name, key in targets:
        fn = getattr(owner, name)

        def timed(*args, _fn=fn, _key=key, **kwargs):
            t = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds.setdefault(_key, []).append(time.perf_counter() - t)
            return out

        saved.append((owner, name, fn))
        setattr(owner, name, timed)
    try:
        yield seconds
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def phase_export(card: str, work: str) -> dict:
    import numpy as np
    import torch
    import torch.export

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.export import pt2, reference
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.train import checkpoint
    from hmd_ego_pose_tpu_torch.train.checkpoint import restore_checkpoint

    with open(reference.REFERENCE) as f:
        ref = json.load(f)
    out_dir = os.path.join(work, "export")
    printed = io.StringIO()
    # the stages of cli export, timed from outside: cmd_export looks its
    # functions up when it runs, export_inference its fold and torch.export's
    stages = [(checkpoint, "restore_checkpoint", "restore"), (pt2, "export_inference", "export_inference"),
              (pt2, "fold_batch_norms", "fold"), (torch.export, "export", "torch_export"),
              (torch.export, "save", "save"), (pt2, "load_and_verify", "load_and_verify"),
              (checkpoint, "save_checkpoint", "save_checkpoint")]
    LAUNCHES.reset()
    t0 = time.perf_counter()
    with timed_calls(stages) as seconds, contextlib.redirect_stdout(printed):
        cli.main(["export", "--ckpt", ARTIFACT, "--quantize-int8", "--out-dir", out_dir])
    total_s = time.perf_counter() - t0
    launches = LAUNCHES.snapshot()
    lines = printed.getvalue().splitlines()
    print("\n".join(lines), flush=True)

    if launches.get("dequantize", 0) != 1 or launches.get("quantize", 0) != 1:
        raise AssertionError(f"the export must launch dequantize and quantize once each, got {launches}")
    want_lines = [line.replace(" in D", f" in {out_dir}") for line in ref["port_printed"]]
    if lines != want_lines:
        raise AssertionError(f"cli export printed {lines}, expected {want_lines}")
    name = "hmd_ego_pose"
    with open(os.path.join(out_dir, f"{name}_input.npy"), "rb") as f:
        input_sha = hashlib.sha256(f.read()).hexdigest()
    with open(os.path.join(out_dir, f"{name}_meta.json")) as f:
        meta_text = f.read()
    if input_sha != ref["input_sha256"] or meta_text != ref["meta_json"]:
        raise AssertionError(f"the seeded input ({input_sha}) or the meta JSON differs from the JAX package's")
    with np.load(os.path.join(out_dir, f"{name}_golden.npz")) as data:
        golden = {k: data[k] for k in data.files}
    gaps, off = reference.hold(golden, ref)
    if off:
        raise AssertionError("the card's golden outputs are off the JAX reference:\n" + "\n".join(off))
    digests = {n: reference.content_digest(os.path.join(out_dir, f"{n}.npz")) for n in ref["weights_digest"]}
    if digests != ref["weights_digest"]:
        raise AssertionError(f"weight files' digests {digests}, the JAX package's {ref['weights_digest']}")
    # the int8 file restores (dequantize on the card) to the shipped artifact's tensors
    got = restore_checkpoint(os.path.join(out_dir, "weights_int8.npz"), "cuda")[:2]
    want = restore_checkpoint(ARTIFACT, "cuda")[:2]
    got_leaves, want_leaves = _leaves(got), _leaves(want)
    if [k for k, _ in got_leaves] != [k for k, _ in want_leaves] or not all(
            torch.equal(a, b) for (_, a), (_, b) in zip(got_leaves, want_leaves)):
        raise AssertionError("weights_int8.npz does not restore to the shipped artifact's tensors")
    fp32_mb, int8_mb, pt2_mb = (os.path.getsize(os.path.join(out_dir, f)) / 1e6
                                for f in ("weights_fp32.npz", "weights_int8.npz", f"{name}.pt2"))
    fp32_s, int8_s = seconds.pop("save_checkpoint")  # weights_fp32, then weights_int8
    seconds = {k: v[0] for k, v in seconds.items()}
    seconds.update(fp32_save=fp32_s, int8_save=int8_s)
    return {
        "seconds": seconds, "total_s": total_s, "pt2_mb": pt2_mb, "fp32_mb": fp32_mb, "int8_mb": int8_mb,
        "fp32_over_int8": fp32_mb / int8_mb, "launches": launches,
        "golden_gap_rel": gaps, "tolerance_rel": ref["tolerance_rel"], "input_sha256": input_sha,
        "weights_digest_equal": True, "int8_restores_to_artifact": True, "card": card,
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


def rgb_to_yuv420(rgb):
    """BT.601 limited-range RGB8 (H, W, 3), H and W even -> (I420, NV12) payloads:
    what an HMD's encoder sends for the frame."""
    import numpy as np

    r, g, b = (rgb[..., c].astype(np.int32) for c in range(3))
    y = np.clip(((66 * r + 129 * g + 25 * b + 128) >> 8) + 16, 16, 235).astype(np.uint8)
    u = np.clip(((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128, 16, 240)[::2, ::2].astype(np.uint8)
    v = np.clip(((112 * r - 94 * g - 18 * b + 128) >> 8) + 128, 16, 240)[::2, ::2].astype(np.uint8)
    return y.tobytes() + u.tobytes() + v.tobytes(), y.tobytes() + np.stack([u, v], -1).tobytes()


def hmd_offers(url: str, offers: int = 5) -> tuple:
    """The HMD's half of the node-dss bootstrap at ``url``, ``offers`` times:
    offer to the workstation, wait for its answer.  Returns (the endpoint of
    the last answer, ms from each offer to its answer)."""
    from hmd_ego_pose_tpu_torch.serving.signaling_client import ANSWER, OFFER, Message, NodeDssSignalerClient

    hmd = NodeDssSignalerClient(url, "hmd", "workstation", poll_interval=0.02, timeout=5.0)
    times = []
    for _ in range(offers):
        t = time.perf_counter()
        hmd.send(Message(OFFER, "pseudo-sdp"))
        answer = hmd.wait_for(ANSWER, timeout=10.0)
        times.append((time.perf_counter() - t) * 1e3)
        if answer is None:
            raise AssertionError("no ANSWER to the HMD's OFFER within 10 s")
    return json.loads(answer.data), times


def profile_requests(client, payloads, kind: int, size) -> dict:
    """torch.profiler (``utils/profiler.py::profile_trace``) over one request of
    each payload, per request: host milliseconds (the client's wall clock),
    device milliseconds (the card's own events) and the device time the aten
    ops account for, kernels, launch calls and aten calls (nested calls
    included), the top ten aten ops by self device time, kernels by device
    time and host rows by self host time."""
    from torch.autograd import DeviceType

    from hmd_ego_pose_tpu_torch.utils.profiler import profile_trace

    n = len(payloads)
    with tempfile.TemporaryDirectory(prefix="hegp_prof_") as log_dir:
        with profile_trace(log_dir) as prof:
            t = time.perf_counter()
            for payload in payloads:
                if client.infer_encoded(payload, kind, *size) is None:
                    raise AssertionError("a profiled request got no detection")
            host_ms = (time.perf_counter() - t) * 1e3 / n
        trace_mb = os.path.getsize(prof.trace_path) / 1e6
    events = prof.key_averages()
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    kernels = [e for e in on_device(events) if not e.key.startswith(("Memcpy", "Memset"))]
    device_ms = sum(device_us(e) for e in on_device(events)) / 1e3 / n
    launch_calls = sum(e.count for e in ops if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))

    def top10(rows, key):
        return [{"name": e.key[:96], "ms_per_request": key(e) / 1e3 / n, "calls_per_request": e.count / n}
                for e in sorted(rows, key=key, reverse=True)[:10] if key(e) > 0]

    return {
        "requests": n, "host_ms": host_ms, "device_ms": device_ms or None,
        "device_busy_share": device_ms / host_ms if device_ms else None,
        "ops_device_ms": sum(device_us(e) for e in ops) / 1e3 / n,
        "kernels_per_request": sum(e.count for e in kernels) / n, "launch_calls_per_request": launch_calls / n,
        "aten_calls_per_request": sum(e.count for e in ops if e.key.startswith("aten::")) / n,
        "top10_ops_self_device": top10([e for e in ops if e.key.startswith("aten::")], device_us),
        "top10_kernels": top10(kernels, device_us),
        "top10_self_host": top10(ops, lambda e: float(e.self_cpu_time_total)),
        "trace_mb": trace_mb,
    }


def serve_yuv(endpoint: dict, frames) -> dict:
    """Over the endpoint the HMD was answered with: every frame as I420 and as
    NV12, each answer a detection and byte-equal to the packet the same server
    answers for the RGB8 frame ``serving/frameio.py`` decodes from that
    payload; the server's conversions must all have taken the compiled path.
    Then three I420 requests under the profiler."""
    import numpy as np

    from hmd_ego_pose_tpu_torch.serving import frameio, protocol
    from hmd_ego_pose_tpu_torch.serving.server import PoseClient

    size = frames.shape[1:3]
    kinds = {"i420": (protocol.KIND_I420, frameio.i420_to_rgb), "nv12": (protocol.KIND_NV12, frameio.nv12_to_rgb)}
    payloads = {name: [] for name in kinds}
    for frame in frames:
        i420, nv12 = rgb_to_yuv420(frame)
        payloads["i420"].append(i420)
        payloads["nv12"].append(nv12)
    if endpoint["frame_kinds"] != ["rgb8", "i420", "nv12"]:
        raise AssertionError(f"the answer names other frame kinds: {endpoint}")
    rtts = {name: [] for name in kinds}
    with PoseClient(endpoint["host"], endpoint["port"], timeout=60.0) as client:
        want = {}
        for name, (_, convert) in kinds.items():
            for i, payload in enumerate(payloads[name]):
                pose = client.infer(convert(np.frombuffer(payload, np.uint8), *size))
                if pose is None:
                    raise AssertionError(f"{name} frame {i}: the decoded RGB8 frame got no detection")
                want[name, i] = protocol.encode_pose_packet(*pose)
        frameio.CONVERSIONS.reset()
        for name, (kind, _) in kinds.items():
            for i, payload in enumerate(payloads[name]):
                t = time.perf_counter()
                pose = client.infer_encoded(payload, kind, *size)
                rtts[name].append((time.perf_counter() - t) * 1e3)
                if pose is None:
                    raise AssertionError(f"{name} frame {i}: no detection served")
                got = protocol.encode_pose_packet(*pose)
                if got != want[name, i]:
                    raise AssertionError(
                        f"{name} frame {i}: packet {np.frombuffer(got, '<f4').tolist()} differs from the "
                        f"decoded RGB8 frame's {np.frombuffer(want[name, i], '<f4').tolist()}")
        conversions = frameio.CONVERSIONS.snapshot()
        if conversions != {"native": 2 * len(frames)}:
            raise AssertionError(f"the server's YUV conversions did not all take the compiled path: {conversions}")
        profile = profile_requests(client, payloads["i420"][:3], protocol.KIND_I420, size)
    return {
        "frames_per_kind": len(frames), "byte_equal_to_rgb8_of_decoded": 2 * len(frames),
        "conversions": conversions,
        **{f"rtt_ms_{name}_p50": float(np.percentile(v, 50)) for name, v in rtts.items()},
        **{f"rtt_ms_{name}_max": max(v) for name, v in rtts.items()},
        "profile": profile,
    }


def phase_serve(dev, golden, frames, outputs, cams, cfg, card: str) -> dict:
    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.eval import golden as hold
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.serving import signaling
    from hmd_ego_pose_tpu_torch.serving.server import PoseClient, PoseServer
    from hmd_ego_pose_tpu_torch.train.checkpoint import restore_checkpoint
    from hmd_ego_pose_tpu_torch.utils.device import UPLOADS

    # the restore alone, three times: its host-to-device copies and seconds
    restore_s = []
    for _ in range(3):
        UPLOADS.reset()
        t0 = time.perf_counter()
        restore_checkpoint(ARTIFACT, dev)
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - t0)
        restore_uploads = UPLOADS.snapshot()
        if restore_uploads != RESTORE_UPLOADS:
            raise AssertionError(f"the restore's host-to-device copies are {restore_uploads}, not {RESTORE_UPLOADS}")

    LAUNCHES.reset()
    UPLOADS.reset()
    t0 = time.perf_counter()
    engine = cli.build_engine(ARTIFACT, dev, frame_size=frames.shape[1], score_threshold=0.1)
    server = PoseServer(engine, host="127.0.0.1", port=0).start()
    t_start = time.perf_counter() - t0
    if UPLOADS.snapshot() != RESTORE_UPLOADS:
        raise AssertionError(f"cli serve's restore made the copies {UPLOADS.snapshot()}")
    host, port = server.address
    rtts, reports = [], []
    sig = responder = None
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
        # cli serve --signaling-url: the workstation answers the HMD's offer
        sig = signaling.SignalingServer(port=0).start()
        url = "http://%s:%d/" % sig.address
        responder = cli.start_signaling(cli.build_parser().parse_args(["serve", "--signaling-url", url]),
                                        server, poll_interval=0.02)
        endpoint, bootstrap_ms = hmd_offers(url)
        if (endpoint["host"], endpoint["port"]) != (host, port):
            raise AssertionError(f"the answer names {endpoint}, the server listens on {host}:{port}")
        yuv = serve_yuv(endpoint, frames)
        stats = engine.stats()
    finally:
        if responder is not None:
            responder.stop()
        if sig is not None:
            sig.stop()
        server.stop(timeout=10.0)
    launches = LAUNCHES.snapshot()
    return {
        "frames": len(reports), "startup_s": t_start, "restore_s": restore_s,
        "restore_uploads": restore_uploads,
        "worst": hold.worst(reports),
        "tie_switches": sum(r["tie_switch"] for r in reports),
        "rtt_ms_p50": float(np.percentile(rtts, 50)), "rtt_ms_max": max(rtts),
        "signaling_bootstrap_ms": bootstrap_ms, "signaling_bootstrap_ms_p50": float(np.median(bootstrap_ms)),
        "endpoint": endpoint, **yuv,
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


# cli make-synthetic's flags of the two sets: the v3 set of the evaluate and
# training phases, and train_multi's two-object set
V3_SET = ("syn1000_v3_256", ["--num-frames", "1000", "--frame-size", "256", "--hand-render-version", "3"])
MULTI_SET = ("multi2_v3_256", [*V3_SET[1][:1], "400", *V3_SET[1][2:], "--num-objects", "2"])
GENERATE_TIMEOUT_S = 300


def start_generation(work: str, spec: tuple) -> subprocess.Popen:
    """``cli make-synthetic`` of ``spec`` into ``work`` in a process of its own
    (``--generate``): host numpy that runs while the card's phases do."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), "--generate",
                             os.path.join(work, spec[0]), *spec[1]],
                            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_generation(proc: subprocess.Popen) -> dict:
    """Waits for ``start_generation``'s process: its own seconds, and how long the caller waited."""
    t = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=GENERATE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"make-synthetic failed ({proc.returncode}):\n{err[-3000:]}")
    return {**json.loads(out.strip().splitlines()[-1]), "generate_wait_s": time.perf_counter() - t}


def phase_evaluate(card: str, data: str, generation: subprocess.Popen) -> dict:
    """Wait for the v3 set's generation into ``data`` (kept for the train phases) and evaluate on it."""
    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES

    with open(EVAL_REFERENCE) as f:
        reference = json.load(f)
    with open(ARTIFACT[: -len(".npz")] + ".json") as f:
        sidecar = json.load(f)["eval"]
    generated = finish_generation(generation)
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
        "frames": frames, **generated, "read_s": t_read, "evaluate_s": t_evaluate,
        "gt_0_yml_sha256": gt_hash, "launches": launches, "scalars": got,
        "worst_gap": worst, "tolerances": EVAL_TOLERANCES,
        "tpu_bf16_sidecar_for_reference_only": {k: sidecar[k] for k in (
            "translation_error_mean_mm", "rotation_error_mean_deg", "hand_error_mean_mm")},
        "card": card,
    }


CLI_REFERENCE = os.path.join(HERE, "hmd_ego_pose_tpu_torch", "eval", "references", "cli_rest.json")
# the iter-1 checkpoint: the shipped artifact plus iterative-subnet leaves drawn
# from RandomState(ITER_SEED), scaled so that the refinement moves the poses
# and keeps the detections (scripts/make_cli_reference.py draws the same)
ITER_SEED, ITER_SCALE = 13, 0.01
# format-labels: seeded per-frame pickles of LABEL_SIZE px, the same as the reference script's
LABEL_FRAMES, LABEL_SIZE, LABEL_SEED = 8, 256, 13
PARITY_TOLERANCE_REL = 1e-4


def add_iter_leaves(flat: dict, template: dict) -> dict:
    """The flat checkpoint leaves ``flat`` ("params/..." and "bn/..." keys)
    and, for every key of ``template`` that they lack (the iterative
    subnets'), a float32 leaf drawn in sorted key order from
    ``RandomState(ITER_SEED)``: BN variances 1, means 0, scales
    1 + ITER_SCALE u, every other leaf ITER_SCALE u, u uniform in [-1, 1).
    Uniform draws are plain arithmetic, so every machine draws the same bits."""
    import numpy as np

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


def write_iter1_checkpoint(directory: str, device=None) -> tuple:
    """The artifact restored on ``device`` (None: the card), its flat leaves
    completed to an ``iter_steps=1`` model's by ``add_iter_leaves``, saved
    with the int8 backend (quantized on ``device``) as
    ``<directory>/iter1_int8.npz``.  Returns (path, the artifact's params, bn_state)."""
    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
    from hmd_ego_pose_tpu_torch.models.weights import to_jax_params
    from hmd_ego_pose_tpu_torch.train.checkpoint import _flatten, _unflatten, restore_checkpoint, save_checkpoint

    def flat(params, bn_state):
        return {**{"params/" + k: v for k, v in _flatten(params).items()},
                **{"bn/" + k: v for k, v in _flatten(bn_state).items()}}

    import torch

    from hmd_ego_pose_tpu_torch.utils.device import resolve_device

    params, bn_state, meta = restore_checkpoint(ARTIFACT, device)
    cfg = ModelConfig(iter_steps=1)
    restored = flat(params, bn_state)
    full = add_iter_leaves(restored, flat(*to_jax_params(HMDEgoPose(cfg).state_dict(), cfg)))
    # the drawn leaves join the restored ones on their device: the int8 save quantizes them as one group
    dev = resolve_device(device)
    full = {k: v if k in restored else torch.from_numpy(v).to(dev) for k, v in full.items()}
    path = save_checkpoint(directory, "iter1_int8",
                           _unflatten({k[len("params/"):]: v for k, v in full.items() if k.startswith("params/")}),
                           _unflatten({k[len("bn/"):]: v for k, v in full.items() if k.startswith("bn/")}),
                           metadata={"hand_relative": meta["hand_relative"]}, backend="int8", device=device)
    return path, params, bn_state


def _signed_permutation(rng):
    """A proper rotation with entries 0 and +-1 (one of 24): products with it are
    exact, so poses built from it round the same under any BLAS."""
    import numpy as np

    while True:
        r = np.zeros((3, 3))
        r[np.arange(3), rng.permutation(3)] = rng.choice([-1.0, 1.0], size=3)
        if round(np.linalg.det(r)) == 1:
            return r


def label_pickles(directory: str, frames: int = LABEL_FRAMES, size: int = LABEL_SIZE) -> list:
    """``frames`` seeded per-frame pickles (the format-labels input schema) in
    ``directory``; frame 5's mask is empty (a corrupt frame, skipped).  Each
    mask has its object in the red channel above the threshold and noise
    below it; poses are signed permutations with translations in meters,
    given as 3x4 or 4x4 affines; the camera as ``cam_calib`` or
    ``camera_matrix``; the tip in meters (4 or 3 values) or already in mm.
    Only uniform draws and exact arithmetic: every machine writes the same
    bytes.  Returns the paths."""
    import pickle

    import numpy as np

    rng = np.random.RandomState(LABEL_SEED)
    paths = []
    for i in range(frames):
        mask = rng.randint(0, 11, size=(size, size, 3)).astype(np.uint8)
        x, y = rng.randint(0, size // 2, size=2)
        w, h = rng.randint(8, size // 2, size=2)
        if i != 5:
            mask[y:y + h, x:x + w, 0] = rng.randint(11, 256)
        affine = np.eye(4)
        affine[:3, :3] = _signed_permutation(rng)
        affine[:3, 3] = [rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1), rng.uniform(0.3, 0.7)]
        focal = rng.uniform(0.8, 1.2) * size
        record = {
            "rgb": rng.randint(0, 256, size=(size, size, 3)).astype(np.uint8),
            "mask": mask,
            "affine_transform": affine if i % 2 else affine[:3],
            "cam_calib" if i % 2 == 0 else "camera_matrix": np.array(
                [[focal, 0.0, size / 2], [0.0, focal, size / 2], [0.0, 0.0, 1.0]]),
            "coords_3d": rng.uniform(-0.1, 0.1, size=(21, 3)) + affine[:3, 3],
            "drill_tip_transform": (np.array([*rng.uniform(-0.3, 0.3, size=3), 1.0]),
                                    rng.uniform(-0.3, 0.3, size=3),
                                    np.array([*rng.uniform(-300, 300, size=3), 1.0]))[i % 3],
        }
        paths.append(os.path.join(directory, f"{i:05d}.pkl"))
        with open(paths[-1], "wb") as f:
            pickle.dump(record, f, protocol=4)
    return paths


def npz_digest(path: str) -> str:
    """sha256 over (name, dtype, shape, C-ordered bytes) of an ``.npz``'s members in
    sorted order: equal for equal contents whatever the member order."""
    import numpy as np

    h = hashlib.sha256()
    with np.load(path) as data:
        for name in sorted(data.files):
            a = data[name]
            h.update(f"{name}\0{a.dtype.str}\0{a.shape}\0".encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def tree_digests(root: str) -> dict:
    """{relative path: sha256} of a LINEMOD tree: YAML and split files by their
    bytes, ``.npy`` by dtype, shape and values, PNGs by their decoded pixels."""
    import numpy as np

    from hmd_ego_pose_tpu_torch.data.image import read_png

    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            if name.endswith(".png"):
                a = read_png(path)
                body = f"{a.dtype}{a.shape}".encode() + a.tobytes()
            elif name.endswith(".npy"):
                a = np.load(path)
                body = f"{a.dtype}{a.shape}".encode() + np.ascontiguousarray(a).tobytes()
            else:
                with open(path, "rb") as f:
                    body = f.read()
            out[os.path.relpath(path, root)] = hashlib.sha256(body).hexdigest()
    return dict(sorted(out.items()))


def hold_parity(got: dict, want: dict) -> dict:
    """``cli parity``'s statistics and head rows against the JAX reference: each
    number within PARITY_TOLERANCE_REL of the larger of its own size and its
    layer's absmax (a head's largest value), so that a mean near zero is held
    at the layer's scale.  Returns the largest such relative gap."""
    off, worst = [], 0.0
    if sorted(got["stats"]) != sorted(want["stats"]) or sorted(got["heads"]) != sorted(want["heads"]):
        raise AssertionError(f"parity layers differ: {sorted(got['stats'])} / {sorted(want['stats'])}")
    rows = [(f"{name} {kind}", g, w, want["stats"][name][2])
            for name in want["stats"] for kind, g, w in zip(("mean", "std", "absmax"), got["stats"][name],
                                                             want["stats"][name])]
    rows += [(f"{field}[{i}]", g, w, max(abs(v) for v in want["heads"][field]))
             for field in want["heads"] for i, (g, w) in enumerate(zip(got["heads"][field], want["heads"][field]))]
    for what, g, w, scale in rows:
        gap = abs(g - w) / max(abs(w), scale, 1e-12)
        worst = max(worst, gap)
        if not gap <= PARITY_TOLERANCE_REL:
            off.append(f"{what}: card {g!r}, JAX {w!r}, rel gap {gap:.3g}")
    if off:
        raise AssertionError("cli parity is off the JAX reference:\n" + "\n".join(off))
    return {"values": len(rows), "max_rel_gap": worst}


def phase_cli_rest(card: str, data: str, work: str) -> dict:
    """The rest of the CLI on the card, held to ``cli_rest.json`` (the JAX
    package's, ``scripts/make_cli_reference.py``), with the launch counts reset
    just before and read just after: an iter-1 checkpoint saved int8, its
    ``cli evaluate --iter 1 --save-images-path`` and four training steps,
    ``cli format-labels`` and ``cli debug``, and ``cli parity``."""
    import shutil

    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
    from hmd_ego_pose_tpu_torch.data.image import read_png
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.models.weights import from_jax_params
    from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

    with open(CLI_REFERENCE) as f:
        reference = json.load(f)
    quiet, seconds = io.StringIO(), {}
    LAUNCHES.reset()

    # 1. the iter-1 checkpoint: the artifact restored on the card (dequantize),
    # the seeded iterative leaves added, saved int8 (quantize)
    t = time.perf_counter()
    ckpt, params, bn_state = write_iter1_checkpoint(work)
    seconds["iter1_checkpoint"] = time.perf_counter() - t
    digest = npz_digest(ckpt)
    if digest != reference["iter1_checkpoint"]["npz_digest"]:
        raise AssertionError(f"the iter-1 int8 checkpoint's content digest {digest} is not the JAX package's "
                             f"{reference['iter1_checkpoint']['npz_digest']}")

    # 2. cli evaluate --iter 1 --save-images-path on the 200 val frames
    images = os.path.join(work, "iter1_images")
    t = time.perf_counter()
    with contextlib.redirect_stdout(quiet):
        result = cli.main(["evaluate", "--dataset-path", data, "--ckpt", ckpt, "--partition", "val", "--iter", "1",
                           "--save-images-path", images])
    seconds["evaluate"] = time.perf_counter() - t
    got = result.scalars()
    worst = {kind: 0.0 for kind in EVAL_TOLERANCES}
    off = []
    for name, want in reference["evaluate"]["scalars"].items():
        kind = scalar_kind(name)
        gap = abs(got[name] - want)
        worst[kind] = max(worst[kind], gap)
        if gap > EVAL_TOLERANCES[kind] + 1e-12:
            off.append(f"{name}: card {got[name]!r}, JAX {want!r}, gap {gap:.6g} > {EVAL_TOLERANCES[kind]}")
    if off:
        raise AssertionError("the card's iter-1 evaluation is off the JAX reference:\n" + "\n".join(off))
    written = sorted(os.listdir(images))
    det = [f[len("det_"):] for f in written if f.startswith("det_")]
    panels = [f[len("samplevis_"):] for f in written if f.startswith("samplevis_")]
    if len(det) != result.num_matched or det != panels or len(written) != 2 * len(det):
        raise AssertionError(f"{len(det)} det_ and {len(panels)} samplevis_ files for {result.num_matched} true "
                             f"positives ({len(written)} files)")
    shapes = {read_png(os.path.join(images, "det_" + det[0])).shape,
              read_png(os.path.join(images, "samplevis_" + det[0])).shape}
    if shapes != {(256, 256, 3), (800, 800, 3)}:
        raise AssertionError(f"overlay and figure shapes {shapes}")

    # 3. four fixed training steps at --iter 1 from the same checkpoint
    t = time.perf_counter()
    args = cli.build_parser().parse_args(["train", "--dataset-path", data, "--ckpt", ckpt, "--iter", "1",
                                          "--epo", "1"])
    with contextlib.redirect_stdout(quiet):
        trainer = cli.build_trainer(args, logger=MetricLogger(os.path.join(work, "runs_iter1"), stdout=False),
                                    checkpoint_dir=os.path.join(work, "iter1_ckpt"))
    steps = []

    def step(s):
        metrics = trainer.step_fn(trainer.data, fixed_batch(trainer, s), None, None)
        steps.append({k: float(v) for k, v in metrics.items()})
        return metrics

    train_gaps = hold_to_reference(reference["train"], step, "iter-1 training")
    del trainer
    torch.cuda.empty_cache()
    seconds["train_steps"] = time.perf_counter() - t

    # 4. cli format-labels of the seeded pickles, read back, and cli debug of it
    t = time.perf_counter()
    pickles, labels, viz = (os.path.join(work, d) for d in ("pickles", "labels", "debug"))
    os.makedirs(pickles)
    label_pickles(pickles)
    with contextlib.redirect_stdout(quiet):
        cli.main(["format-labels", "--in-dir", pickles, "--out-dir", labels])
    got_digests, want_digests = tree_digests(labels), reference["format_labels_digests"]
    if got_digests != want_digests:
        bad = sorted(k for k in set(got_digests) | set(want_digests) if got_digests.get(k) != want_digests.get(k))
        raise AssertionError(f"cli format-labels' output differs from the JAX package's: {bad}")
    shutil.copytree(os.path.join(data, "models"), os.path.join(labels, "models"))
    read = ColibriDataset(labels, 0, 1, "train")
    annotations = [read.load_annotations(i) for i in range(len(read))]
    if len(read) != 4 or not all(np.isfinite(a["translations"]).all() for a in annotations):
        raise AssertionError(f"the converted set reads back as {len(read)} train frames")
    with contextlib.redirect_stdout(quiet):
        cli.main(["debug", "--dataset-path", labels, "--out-dir", viz, "--num-images", "8"])
    debug_digests = tree_digests(viz)
    if debug_digests != reference["debug_digests"]:
        raise AssertionError(f"cli debug's overlays differ from the JAX package's (PIL): {sorted(debug_digests)}")
    seconds["format_labels_debug"] = time.perf_counter() - t

    # 5. cli parity of the artifact as a module.-prefixed torch state_dict, fp32 on the card
    t = time.perf_counter()
    pth = os.path.join(work, "artifact_state_dict.pth")
    torch.save({"module." + k: v.cpu() for k, v in from_jax_params(params, bn_state, ModelConfig()).items()}, pth)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        parity = cli.main(["parity", "--torch-ckpt", pth])
    seconds["parity"] = time.perf_counter() - t
    if parity["report"] != {"missing": [], "unused": []}:
        raise AssertionError(f"the artifact's state_dict did not load strictly: {parity['report']}")
    held = hold_parity(parity, reference["parity"])
    names = [line.split()[0] for line in printed.getvalue().splitlines() if line.startswith("  ")]
    want_names = [line.split()[0] for line in reference["parity"]["printed"].splitlines() if line.startswith("  ")]
    if names != want_names or not printed.getvalue().startswith("converted: 0 missing, 0 unused keys"):
        raise AssertionError(f"cli parity printed other rows than the JAX package's: {names}")
    launches = LAUNCHES.snapshot()
    want_launches = {"dequantize": 3, "quantize": 1, "min_distances": 1, "target_assign": 4}
    if launches != want_launches:
        raise AssertionError(f"cli_rest launches {launches}, expected {want_launches} (dequantize: the artifact, the "
                             "evaluation's and the trainer's restores)")
    return {
        "seconds": seconds, "iter1_npz_digest": digest, "scalars": got, "worst_gap": worst,
        "tolerances": EVAL_TOLERANCES, "true_positives": result.num_matched, "image_files": len(written),
        "train_max_rel_gap": train_gaps, "train_tolerance_rel": reference["train"]["tolerance_rel"],
        "train_steps": steps, "format_labels_files": len(reference["format_labels_digests"]),
        "debug_files": len(debug_digests), "parity": held, "launches": launches, "card": card,
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
    if sys.argv[1:2] == ["--train-dp-rank"]:  # one rank of the train_dp phase
        print(json.dumps(train_dp_rank(*sys.argv[2:6])), flush=True)
        faulthandler.cancel_dump_traceback_later()
        return 0
    if sys.argv[1:2] == ["--generate"]:  # a set of start_generation
        from hmd_ego_pose_tpu_torch import cli

        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["make-synthetic", "--out-dir", *sys.argv[2:]])
        print(json.dumps({"generate_s": time.perf_counter() - t}), flush=True)
        faulthandler.cancel_dump_traceback_later()
        return 0
    from hmd_ego_pose_tpu_torch.utils.device import resolve_device

    t_all = time.perf_counter()
    dev = resolve_device("cuda")
    card = nvidia_smi()
    emit("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    # the two synthetic sets are host numpy: they are generated in processes of
    # their own while the phases before the evaluate phase use the card
    work = tempfile.mkdtemp(prefix="hegp_v3_")
    children = {name: start_generation(work, spec) for name, spec in (("v3", V3_SET), ("multi", MULTI_SET))}
    try:
        return run_phases(dev, card, work, children, t_all)
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(work, ignore_errors=True)


def run_phases(dev, card: str, work: str, children: dict, t_all: float) -> int:
    """Every phase after the device line, then the kernels, nvidia-smi and ok
    lines.  ``children`` holds the processes the phases wait for; the caller
    kills whichever are left."""
    import torch

    from hmd_ego_pose_tpu_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build_all()
    emit("build", seconds=time.perf_counter() - t0, built=sorted(built), sources=build.sources())

    kernel = phase_kernel(dev)
    emit("kernel", card=card, **kernel)

    min_dist = phase_min_distances(dev)
    emit("kernel_min_distances", card=card, **min_dist)

    targets = phase_target_assign(dev)
    emit("kernel_target_assign", card=card, **targets)

    quant = phase_quantize(dev)
    emit("kernel_quantize", card=card, **quant)

    golden, frames, cameras = read_golden()
    predict, outputs, cams, cfg = phase_predict(dev, golden, frames, cameras)
    emit("predict", card=card, **predict)

    serve = phase_serve(dev, golden, frames, outputs, cams, cfg, card)
    emit("serve", **serve)

    data = os.path.join(work, V3_SET[0])
    evaluate = phase_evaluate(card, data, children["v3"])
    emit("evaluate", **evaluate)
    # train_dp's ranks start up (import, restore, data upload) while the train phase runs
    go = os.path.join(work, "dp_go")
    children.update(zip(("dp0", "dp1"), start_dp_ranks("gloo", data, os.path.join(work, "dp"), go)))
    train = phase_train(card, data, work)
    emit("train", **train)
    dp = phase_train_dp(card, data, work, train, [children["dp0"], children["dp1"]], go)
    emit("train_dp", **dp)
    multi = phase_train_multi(card, work, children["multi"])
    emit("train_multi", **multi)
    windowed = phase_train_windowed(card, data, work, train["peak_mem_gb"])
    emit("train_windowed", **windowed)
    host = phase_train_host(card, data, work, train)
    emit("train_host", **host)
    remat = phase_train_remat(card, data, work)
    emit("train_remat", **remat)
    export = phase_export(card, work)
    emit("export", **export)
    rest = phase_cli_rest(card, data, work)
    emit("cli_rest", **rest)

    leftover = [t.name for t in threading.enumerate()
                if t is not threading.main_thread() and t.is_alive() and not t.daemon]
    if leftover:
        raise RuntimeError(f"threads still alive after shutdown: {leftover}")
    emit("shutdown", threads_alive=[t.name for t in threading.enumerate() if t.is_alive()],
         total_s=time.perf_counter() - t_all)

    # every count is read from a main path's run: target_assign summed over the
    # training runs (the data-parallel one's over its two ranks and cli_rest's
    # iter-1 steps), min_distances over the evaluation, the two-class
    # validation and the iter-1 evaluation, dequantize over serve and cli_rest,
    # quantize over export and cli_rest's int8 save
    trainings = (train, multi, windowed, host, remat, dp, rest)
    launches = {"dequantize": sum(p["launches"].get("dequantize", 0) for p in (serve, rest)),
                "min_distances": sum(p["launches"].get("min_distances", 0) for p in (evaluate, multi, rest)),
                "quantize": sum(p["launches"].get("quantize", 0) for p in (export, rest)),
                "target_assign": sum(p["launches"].get("target_assign", 0) for p in trainings)}
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
            "launch_ms": kernel["launch_ms"],
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
            "launch_ms": min_dist["launch_ms"],
            "plain_ms": min_dist["plain_ms"],
            "bound_ms": min_dist["bound_ms"],
            "bound_by": min_dist["bound_by"],
            "library_ms": min_dist["library_ms"],
        },
        {
            "name": "quantize",
            "route": "cuda",
            "source": "hmd_ego_pose_tpu_torch/csrc/quantize.cu",
            "replaces": "hmd_ego_pose_tpu/ops/quantization.py:39",
            "launches": launches["quantize"],
            "max_abs_err": quant["max_abs_err"],
            "ms": quant["kernel_ms"],
            "launch_ms": quant["launch_ms"],
            "plain_ms": quant["plain_ms"],
            "bound_ms": quant["bound_ms"],
            "bound_by": quant["bound_by"],
            "library_ms": quant["library_ms"],
        },
        {
            "name": "target_assign",
            "route": "cuda",
            "source": "hmd_ego_pose_tpu_torch/csrc/target_assign.cu",
            "replaces": "hmd_ego_pose_tpu/ops/pallas_kernels.py:69",
            "launches": launches["target_assign"],
            "max_abs_err": targets["max_abs_err"],
            "ms": targets["kernel_ms"],
            "launch_ms": targets["launch_ms"],
            "plain_ms": targets["plain_ms"],
            "bound_ms": targets["bound_ms"],
            "bound_by": targets["bound_by"],
            "library_ms": targets["library_ms"],
        },
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
