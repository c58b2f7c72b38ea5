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
               and max per kind; one I420 request under
               ``utils/profiler.py::profile_trace``: host and device ms,
               kernels, launch and aten calls, the top ten aten ops by self
               device time, kernels by device time and host rows by self host
               time, each per request.  Kernel launch counts are reset just before
               the engine is built and read just after the phase.  The engine
               serves through CUDA graphs, one per batch size, captured by its
               warm-up: ``eager_batches`` must stay 0; each batch size's replay
               of the golden frames must equal the eager ``_predict`` of the
               same frames bit for bit, and two batches of one size in flight
               must each resolve to their own eager answers; then batch-1
               round trips, graph against eager in turns (the eager turns with
               the graphs set aside), and one profiled request of each (kernels,
               launch calls, graph launches, host and device ms); the
               capture's seconds and the graphs' pool bytes.
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
               The evaluation predicts through one CUDA graph
               (``train/step.py::EvalForward``, captured once); then its
               first six batches again, replayed and eager in turns,
               bit-equal in all six detection fields, with the p50 ms a
               batch of each.
10. train   -- on the same set: first four fixed training steps (augmentation
               and drop-connect off) of ``cli train``'s trainer from the
               artifact, eagerly and then, from the same state, through the
               trainer's CUDA graph of its step (``train/step.py::ResidentGraph``),
               whose six loss terms must each lie within the stated
               tolerance of ``hmd_ego_pose_tpu_torch/train/references/
               handrel_v3_train_steps.json`` (the JAX package's steps,
               ``scripts/make_train_reference.py``), ``target_assign`` launched
               once per replay; the gradient leaves that differ between two
               backwards of one batch from one state (cuDNN's default
               algorithms); with ``cudnn.deterministic`` four augmented steps
               with drop-connect, eager (colour ops grouped by op) and graphed
               (colour ops in fixed shapes inside the graph) with the same
               indices, draws and masks, bit-equal in losses and state; two steps of
               each path in turns, timed, and of the deterministic graph beside
               the default one (deterministic cuDNN's cost); then, with the launch
               counts reset just before and read just after, ``cli train``'s
               trainer (``cli.build_trainer``: phi-0, 256 px, fp32, batch 16,
               Adam 1e-4, frozen backbone, oversample 1) for one epoch over the
               600 train frames, replaying its step's graph, and validation on
               the 200 val frames.  Every
               loss finite, ``target_assign`` launched once per step,
               ``dequantize`` once at the restore,
               ``min_distances`` once; the backbone's
               parameters bit-identical and its BN statistics moved; the best
               and ``last`` checkpoints written and restored to the trained
               model, ``last`` with the optimizer's leaves.  Times: step p50 and
               max (synchronised) and its parts, images/s, epoch, validation
               and start-up seconds, and a torch.profiler sample of one more
               step (device time, kernel launch, graph launch and copy calls
               per step, busy share; the sample's time is
               nearly all the profiler's own, so it is kept to one step).
               Validation predicts through one graph (``captures`` 1).  The
               fixed-shape colour pass against the grouped one at 256x256 and
               480x640 (``colour_cases``), bit-equal, with the ms of each.
11. train_dp -- data-parallel training: two ranks of ``cli train``'s trainer
               (``cli.build_trainer`` under torchrun's environment, global batch
               16 split 8 + 8) share the one card over gloo, each a subprocess
               of this script (``--train-dp-rank``) started before the train
               phase so that their start-up overlaps it, stepping once it has
               ended, joined with a timeout.
               Four fixed steps (augmentation and drop-connect off) held to
               ``handrel_v3_train_steps.json`` within its tolerance and to the
               train phase's own four steps within 1e-5 relative; then ``fit``
               of one short epoch (2 augmented steps with drop-connect,
               validation on rank 0 only, its metric broadcast, checkpoints by
               rank 0 only): every step finite, the ranks' losses and state
               digests (parameters and BN buffers) bit-identical after every
               step, ``target_assign`` once per step on each rank, ``dequantize``
               once per rank, ``min_distances`` on rank 0 only.  The gloo
               steps are eager; rank 0's validation predicts through one
               graph (the predict makes no collective), its last batch
               replayed and eager bit-equal, timed.  Step p50 against the
               train phase's, the collective calls per step and their share
               of the step.  With two or more cards the fixed steps run again
               over NCCL, one card per rank, through the trainer's step graph
               with its collectives inside; with one the line says so.
12. mesh_graph -- one NCCL rank on card 0 (``--mesh-graph-rank``, started
               beside train_dp's ranks, its first step at start-up, stepping
               once they have ended), its trainer on ``probe_mesh`` (a
               ``DataMesh`` of one rank that makes every collective through
               ``torch.distributed``): with ``cudnn.deterministic`` four
               fixed steps eagerly on the probe mesh, through the trainer's
               step graph (its 260 collectives inside) and through a
               single-process graph, bit-equal in losses and state and within
               the JAX reference's tolerance; a replay's collectives by kind
               those of the eager step and of train_dp's gloo step; graphed
               steps of both in turns; one replay profiled: 0 kernel launch
               calls, one graph launch, ``target_assign`` once, its
               collectives counted with no host seconds; the engine's graphs
               at batch 1 and 2 on the probe mesh (frame broadcasts and pose
               gather inside) and in one process, each replay bit-equal to
               its eager predict, answering the six golden frames bit-equal
               to each other.  Then, once the train_remat phase has ended,
               beside the export phase's host work (this phase's line
               follows export's), the space axis under capture on
               ``probe_space_mesh`` (the same rank acting as space rank 0 of
               2, rank 1 mirrored; ``space_probe``): four fixed fp32 steps
               on the trainer's model, eager and through the step graph
               (halos, gathered heads, space sums, BN over data x space
               inside), bit-equal, a replay's collectives by kind the eager
               step's, graph and eager steps in turns, one replay profiled
               (0 kernel launch calls, one graph launch, ``target_assign``
               once); the bf16 engine's batch-1 graph on the probe, every
               replay bit-equal to its eager batch, two batches in flight,
               the six frames graphed and eager in turns; the fp32 eval
               forward of the six frames, one capture, bit-equal to eager.
               NCCL moves no data at world 1: the phase shows the capture,
               not NCCL's transport.
13. spatial -- the space axis: two ranks of a data 1 x space 2 mesh share the
               card over gloo (``--spatial-rank``, started beside train_dp's,
               run once it has ended), each restoring the artifact (phi-0,
               256 px) and holding the rows 0-127 or 128-255 of every image:
               ``predict`` (bf16) of the six golden frames one frame a call,
               held to the goldens; the fp32 raw outputs of the six within
               rtol 2e-4, atol 2e-5 of the single-process forward; an engine
               on the mesh (process 0 serves, process 1 follows) answering
               the six frames with the single-process engine's poses within
               the goldens' bounds (2 mm plus one bf16 step of tz); one fp32
               train step at batch 2 within 1e-5 relative of the
               single-process step's losses, every gradient leaf after the
               all-reduce and before Adam within 1e-4 of its norm plus 1e-6
               of the global norm of the single-process step's, its largest
               parameter gap under 5e-3, both ranks' state digests equal; ``dequantize`` once and
               ``target_assign`` once on each rank.  The collective counts and
               ms by kind, the ms of a frame and the phase's wall seconds.
               With two or more cards the same mesh runs again on NCCL, one
               card per rank (``--spatial-nccl-rank``): the engine's batch-1
               graph on both ranks answering the six frames within the
               goldens' bounds and those of the gloo ranks' eager answers,
               and the fp32 step's graph bit-equal to its eager step
               (deterministic cuDNN); with one card the line says
               ``"nccl": "not run: 1 card"``.
14. train_multi -- ``cli make-synthetic --num-objects 2`` writes the 400-frame,
               256 px two-object set (fold 0: 240 train, 80 val; in a
               process of its own started beside the v3 set's), whose
               ``gt_0.yml`` must hash as the JAX generator's did; the artifact
               widened to two classes (``models/weights.py::widen_classes``)
               is saved as the start; four fixed steps of ``cli train
               --object-ids 1,2``'s trainer through its step graph (object 2
               is symmetric: the fixed-shape minimum distance in the graph)
               held to
               ``hmd_ego_pose_tpu_torch/train/references/multi2_v3_train_steps.json``;
               the graph against the eager step (``variant_graph_against_eager``,
               below); then one epoch through the graph (oversample 1,
               augmentation on: the multi-object warp) and validation: every
               loss finite, ``target_assign`` once per step, ``min_distances``
               twice (once per class), the checkpoints written and restored;
               the two-class validation through one captured graph, its last
               batch replayed and eager bit-equal.
15. train_windowed -- the v3 set's 600 train frames with
               ``device_resident_budget_bytes`` of a third of them: three
               windows of 200 frames over one epoch through one step graph
               over the window buffer (``data/device_dataset.py::WindowBuffer``,
               filled in place), each window's index rows cut to its first 2
               steps (6 steps of the epoch's 36), ``target_assign`` once per
               step; one window resident at a time: the buffer one window's
               bytes, every window at its address, and the memory held after
               each fill, over the model and the buffer, within Adam's moments
               and the graph's pool and not growing after the first window;
               the peak beside the resident run's; the graph against the eager
               step.
16. train_host -- ``device_augment=False``: four fixed steps of host batches
               (augmentation off) through the step graph (``HostGraph``)
               held to ``handrel_v3_train_steps.json``, the largest gap
               between the host-preprocessed and the device-preprocessed
               batch of step 0 per field, then an augmented epoch through
               the graph and the host input pipeline (worker threads) cut to
               its first 6 batches (of 37), each wait for the next batch
               timed apart from the replays; then the graph against the eager
               step on three augmented batches made in this thread (the
               host's ms to make one), and on two ``RawBatch``es of
               ``device_resident=False`` (augmented in the graph).
17. train_remat -- ``--no-freeze-backbone``, the same state, batch and
               drop-connect seed through one eager remat and one eager plain
               step: losses equal, BN statistics moved once (as the plain
               step's within 1e-5 relative), parameters finite and within 2 lr
               (one Adam step); then each one's graph against its eager step
               (remat's recompute inside the capture), the graphed remat step's
               time over the graphed plain one's; then ``--fine-tune`` (Nesterov
               SGD over a device learning rate) through its graph the same way.
               ``variant_graph_against_eager``, in phases 14-17: with
               ``cudnn.deterministic``, 2-3 steps from one state eagerly and
               through a new graph, the same draws and masks: losses and state
               bit-equal, ``target_assign`` once a step; two steps of each in
               turns, timed; one replay profiled (0 kernel launch calls, one
               graph launch); the graph's pool and the peak (the raw host
               batches without turns, the plain and SGD steps without the
               profile).
18. export  -- ``cli export --ckpt trained/syn1000_phi0_576ep_handrel_int8.npz
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
19. cli_rest -- the rest of the CLI, held to
               ``hmd_ego_pose_tpu_torch/eval/references/cli_rest.json`` (the
               JAX package's, ``scripts/make_cli_reference.py``), with the
               launch counts reset just before and read just after: the
               artifact restored on the card with seeded iterative-subnet
               leaves added (``add_iter_leaves``) and saved int8
               (``quantize``), its content digest the JAX package's int8
               save's; ``cli evaluate --iter 1 --save-images-path`` of it on
               the v3 set's 200 val frames, every scalar within the evaluate
               phase's tolerances of the JAX evaluation, one ``det_`` /
               ``samplevis_`` pair per true positive, through one captured
               graph (its first two batches replayed and eager bit-equal);
               four fixed training
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
20. shutdown -- server and engine stopped, every thread joined with a timeout;
               ``total_s`` from the first phase, ``process_s`` from the
               process's start (the interpreter and ``import torch``
               included; the exit's teardown is not).

Then the ``kernels`` JSON line (``target_assign``'s launches summed over the
nine training runs, both data-parallel ranks, the probe mesh's steps, the
iter-1 steps, the space probe's and both spatial ranks included, ``min_distances``' over the three evaluations,
``dequantize``'s over serve, cli_rest and the spatial ranks, ``quantize``'s
over export and cli_rest), the nvidia-smi line,
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


def process_seconds() -> float:
    """Seconds since this process started (Linux: its start tick in
    ``/proc/self/stat`` against ``/proc/uptime``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


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
        "spatial_rank_b2": (target_batch(rng, 2, 1, 1), 1, 256),  # a spatial rank's step: its 2 data rows
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


class StepTimes:
    """Synchronised step times and each step's losses, read after the step;
    ``part_ms`` the parts' times where the timer sees them."""

    def __init__(self):
        self.step_ms, self.losses, self.part_ms = [], [], {}

    def summary(self, batch: int, start: int = 0, stop=None) -> dict:
        """Times of the steps ``start`` .. ``stop``."""
        import numpy as np

        step_ms = np.asarray(self.step_ms[start:stop])
        parts = {k: v[start:stop] for k, v in self.part_ms.items()}
        return {
            "steps": len(step_ms), "step_ms_p50": float(np.percentile(step_ms, 50)),
            "step_ms_max": float(step_ms.max()), "step_ms_first": float(step_ms[0]),
            "images_per_s": batch * len(step_ms) / (step_ms.sum() / 1e3),
            "augment_share": float(np.sum(parts["prepare"]) / step_ms.sum()) if parts else None,
            "part_ms_p50": {k: float(np.percentile(v, 50)) for k, v in parts.items()} if parts else None,
            "loss_first": self.losses[start]["loss"], "loss_last": self.losses[start:stop][-1]["loss"],
        }

    def check_finite(self) -> None:
        import numpy as np

        bad = [i for i, m in enumerate(self.losses) if not all(np.isfinite(v) for v in m.values())]
        if bad:
            raise AssertionError(f"non-finite losses at steps {bad}: {[self.losses[i] for i in bad]}")


class TimedGraph(StepTimes):
    """Wraps a trainer's ``ResidentGraph`` (the CUDA graph of its step): each
    step synchronised and timed (the first one's time holds the warm-up step
    and the capture), its losses read from the graph's rows after it."""

    def __init__(self, graph):
        super().__init__()
        self.graph = graph

    def __getattr__(self, name):
        return getattr(self.graph, name)

    def __call__(self, idx, draws=None, generator=None):
        import torch

        from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.graph(idx, draws, generator)
        torch.cuda.synchronize()
        self.step_ms.append((time.perf_counter() - t0) * 1e3)
        self.losses.append(dict(zip(METRIC_NAMES, self.graph.metrics[self.graph.done - 1].tolist())))


class TimedStep(StepTimes):
    """Wraps a trainer's step: synchronised times of its parts (batch, augment
    and preprocess; forward + targets + loss; backward; optimizer update) and
    each step's losses, read after the step (the eager steps of a
    data-parallel rank)."""

    PARTS = ("prepare", "forward", "backward", "optimizer")

    def __init__(self, step):
        super().__init__()
        self.step = step
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


def profile_steps(trainer, steps: int = 1) -> dict:
    """Device busy share of a few more (unsynchronised) train steps of a
    resident trainer under torch.profiler, and the kernels that take the most
    device time; None where the profiler sees no device time.  The steps are
    replays of the trainer's graph: the kernels it runs against the launch
    calls and ``cudaGraphLaunch`` calls the host makes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rows = trainer.pipeline.epoch_indices(1)[:steps]
    graph = trainer.graph.graph if isinstance(trainer.graph, TimedGraph) else trainer.graph
    graph.reset()

    def step(row):
        graph(torch.from_numpy(row), trainer.draws(), trainer.generator)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for row in rows:
            step(row)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    events = on_device(averages)
    busy = sum(device_us(e) for e in events)
    top = sorted(events, key=device_us, reverse=True)[:6]
    return {
        "graphed": trainer.graphed,
        "profiled_steps": len(rows), "wall_ms_per_step": wall_us / 1e3 / len(rows),
        "device_ms_per_step": busy / 1e3 / len(rows) if busy else None,
        "device_busy_share": busy / wall_us if busy else None,
        "kernels_per_step": sum(e.count for e in events if not e.key.startswith(("Memcpy", "Memset"))) / len(rows),
        **launch_calls(averages, len(rows), "step"),
        "top_kernels_ms_per_step": {e.key[:80]: device_us(e) / 1e3 / len(rows) for e in top} if busy else None,
    }


def launch_calls(averages, n: int, unit: str) -> dict:
    """Kernel launch calls, CUDA graph launches and memory copy calls the host made, per ``unit``."""
    from torch.autograd import DeviceType

    ops = [e for e in averages if e.device_type == DeviceType.CPU]
    kernel = sum(e.count for e in ops if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    graph = sum(e.count for e in ops if e.key in ("cudaGraphLaunch", "cuGraphLaunch"))
    copies = sum(e.count for e in ops if e.key in ("cudaMemcpyAsync", "cuMemcpyAsync"))
    return {f"launch_calls_per_{unit}": kernel / n, f"graph_launches_per_{unit}": graph / n,
            f"copy_calls_per_{unit}": copies / n}


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
    """``trainer.fit()`` of a graphed trainer with every replay timed
    (``TimedGraph``) and validation timed; the card synchronised at the end."""
    import torch

    timed = trainer.graph = TimedGraph(trainer.graph)
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


# the colour cases: slot 0 runs every op once (examples 0-12) and the noise op
# twice more; slot 1 draws the noise op three times; examples 3 and 7 have
# one active slot, example 5 is not augmented
COLOUR_OPS = ((0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 10, 10, 5),
              (10, 4, 10, 7, 0, 1, 2, 3, 9, 5, 6, 8, 11, 12, 10, 13))
COLOUR_SIZES = ((256, 256), (480, 640))


def colour_cases(h: int, w: int, seed: int = 0):
    """16 seeded (h, w) frames (noise, gradients, a flat channel) and colour
    draws (``COLOUR_OPS``) on the host."""
    import torch

    from hmd_ego_pose_tpu_torch.ops import augment_device as aug

    g = torch.Generator().manual_seed(seed)
    b = len(COLOUR_OPS[0])
    noise = torch.randint(0, 256, (b, h, w, 3), generator=g)
    ramp = (torch.arange(w)[None, None, :, None] * 255 // max(1, w - 1)).expand(b, h, w, 3)
    frames = torch.where(torch.rand((b, h, 1, 1), generator=g) < 0.5, noise, ramp).to(torch.uint8)
    frames[1, ..., 2] = 77  # a flat channel: autocontrast and equalize keep it
    n_slots = torch.full((b,), 2)
    n_slots[[3, 7]] = 1
    apply = torch.ones(b, dtype=torch.bool)
    apply[5] = False
    draws = aug.AugmentDraws(
        apply, n_slots, torch.tensor(COLOUR_OPS).T.contiguous(), torch.randint(1, 14, (b, 2), generator=g),
        torch.rand((b, 2), generator=g),
        torch.stack([torch.randint(0, h, (b, 2), generator=g), torch.randint(0, w, (b, 2), generator=g)], dim=-1),
        {}, torch.zeros(b), torch.ones(b))
    for slot in range(aug.MAX_SLOTS):
        m = aug.slot_ops(draws, slot).count(aug.GAUSSIAN_NOISE)
        draws.noise[slot] = torch.randn((m, h, w, 3), generator=g)
    return frames, draws


def colour_fixed_against_grouped(dev) -> dict:
    """On the card at each of ``COLOUR_SIZES``: the fixed-shape colour pass
    (the resident step graph's) against ``color_augment_batch`` (grouped by
    op, the eager paths'), bit for bit, and the pass's device ms; and whether ``torch.mean``'s float32 sum of a row's grey levels depends on the rows beside it (3 rows
    against the same rows among 16), which the contrast op's integer sum
    avoids: a finding, not a gate."""
    import torch

    from hmd_ego_pose_tpu_torch.ops import augment_device as aug

    out = {}
    for h, w in COLOUR_SIZES:
        frames, draws = colour_cases(h, w)
        x = frames.to(dev)
        fixed = aug.slot_draws(draws, h, w, dev)
        want = aug.color_augment_batch(x, draws)
        got = aug.color_augment_fixed(x, fixed)
        rows = (got != want).flatten(1).any(dim=1).nonzero().flatten().tolist()
        if rows:
            raise AssertionError(f"at {h}x{w} the fixed-shape colour pass differs from the grouped one in rows {rows}")
        gray = aug._grayscale(x.to(torch.float32))
        float_mean_3 = torch.mean(gray[:3], dim=(1, 2))
        float_mean_16 = torch.mean(gray, dim=(1, 2))[:3]
        out[f"{h}x{w}"] = {
            "bit_equal": True, "fixed_ms": cuda_time_ms(lambda: aug.color_augment_fixed(x, fixed), reps=5),
            "grouped_ms": cuda_time_ms(lambda: aug.color_augment_batch(x, draws), reps=5),
            "float_mean_3_against_16_rows_equal": bool(torch.equal(float_mean_3, float_mean_16)),
        }
    return out


@contextlib.contextmanager
def recording_eval_forwards():
    """``train/step.py::make_eval_forward`` replaced, for ``cli evaluate``
    (which imports it when it runs), by one whose callables keep each
    call's inputs; yields the list of ``RecordingForward``s made."""
    from hmd_ego_pose_tpu_torch.train import step

    made, make = [], step.make_eval_forward

    def recording(*args, **kwargs):
        made.append(RecordingForward(make(*args, **kwargs)))
        return made[-1]

    step.make_eval_forward = recording
    try:
        yield made
    finally:
        step.make_eval_forward = make


class RecordingForward:
    """A predict callable that keeps a copy of each call's inputs."""

    def __init__(self, forward):
        self.forward, self.calls = forward, []

    def __call__(self, images, cameras):
        self.calls.append((images.copy(), cameras.copy()))
        return self.forward(images, cameras)


def eval_graph_against_eager(forward, calls) -> dict:
    """Each recorded batch predicted by ``forward`` (an ``EvalForward``: a
    replay) and eagerly (``forward.eager``), in turns (graph, eager, eager,
    graph, ...), each call synchronised and timed: the six fields bit-equal,
    or the phase fails; the p50 ms a batch of each."""
    import numpy as np

    from hmd_ego_pose_tpu_torch.train.step import EvalForward

    if not isinstance(forward, EvalForward) or forward.captures != 1:
        raise AssertionError(f"the evaluation on the card must predict through one captured graph, got {forward!r}")
    ms = {"graph": [], "eager": []}
    differing = []
    for i, (images, cameras) in enumerate(calls):
        got = {}
        for path in (("graph", "eager") if i % 2 == 0 else ("eager", "graph")):
            t = time.perf_counter()
            got[path] = (forward if path == "graph" else forward.eager)(images, cameras)
            ms[path].append((time.perf_counter() - t) * 1e3)
        differing += [(i, f) for f in got["graph"]._fields
                      if getattr(got["graph"], f).tobytes() != getattr(got["eager"], f).tobytes()]
    if differing or forward.captures != 1:
        raise AssertionError(f"replayed batches differ from the eager predict in (batch, field) {differing[:6]}; "
                             f"captures {forward.captures}")
    return {"batches": len(calls), "bit_equal": True, "captures": forward.captures,
            "batch_ms_p50": {k: float(np.median(v)) for k, v in ms.items()},
            "graph_over_eager": float(np.median(ms["graph"]) / np.median(ms["eager"]))}


AB_STEPS = 4  # graph against eager: augmented steps of each path from one state
TURN_STEPS = 2  # step time in turns: steps of each path, cut to keep the script's time


def restore_state(trainer, state: dict) -> None:
    """Put ``trainer`` back at ``state`` (its model's state_dict, cloned before
    its first step) in place, so that a captured graph still finds every
    tensor where it was: the model's tensors copied back, Adam's moments and
    count zeroed, as before a first step."""
    import torch

    with torch.no_grad():
        model_state = trainer.model.state_dict()
        for k, v in state.items():
            model_state[k].copy_(v)
        for moments in trainer.optimizer.opt.state.values():
            for t in moments.values():
                t.zero_()
    trainer.optimizer.count = 0


def state_gap(a: dict, b: dict) -> dict:
    """Tensors of two state_dicts that differ, and the largest absolute gap."""
    import torch

    differ = [k for k in a if not torch.equal(a[k], b[k])]
    gap = max((float((a[k].double() - b[k].double()).abs().max()) for k in differ), default=0.0)
    return {"tensors_differing": len(differ), "max_abs_gap": gap, "first_differing": differ[:3]}


def graph_against_eager(trainer, reference: dict) -> dict:
    """From the artifact's state, on a trainer built as ``cli train`` builds it:

    1. the four reference steps (augmentation and drop-connect off) through
       the trainer's step graph, then eagerly, each run held to the JAX
       package's losses; ``target_assign`` once per graphed step;
    2. whether the eager step repeats itself: one backward of the first
       reference batch twice from one state, the gradient leaves that differ
       (cuDNN's default weight-gradient algorithms of some convolutions
       accumulate with atomics, so the eager step differs from itself, and
       from the graph, in the last bits);
    3. with ``torch.backends.cudnn.deterministic``: ``AB_STEPS`` augmented
       steps with drop-connect, eagerly and through a graph of their own,
       with the same indices, draws and masks; losses and every parameter
       and BN buffer bit-equal, or the phase fails;
    4. ``TURN_STEPS`` augmented steps of each path in turns (eager, graph,
       deterministic graph, then the reverse, ...), timed: the eager step and
       a graph of its own with cuDNN's defaults, and the graph of 3 (captured
       with ``cudnn.deterministic``: deterministic cuDNN's cost a replay)."""
    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES, ResidentGraph

    if not trainer.graphed:
        raise AssertionError("the resident trainer on the card must hold a step graph")
    dev, batch = trainer.device, trainer.config.train.batch_size
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    def clone():
        torch.cuda.synchronize()
        return {k: v.clone() for k, v in trainer.model.state_dict().items()}

    # 1. the reference steps through the graph, then eagerly
    graph, ref_steps = trainer.graph, []
    LAUNCHES.reset()

    def graph_step(s):
        graph(fixed_batch(trainer, s), None, None)
        metrics = dict(zip(METRIC_NAMES, graph.metrics[s]))
        ref_steps.append({k: float(v) for k, v in metrics.items()})
        return metrics

    t0 = time.perf_counter()
    graph_gaps = hold_to_reference(reference, graph_step, "graphed training")
    ref_graph_s = time.perf_counter() - t0
    steps = len(reference["steps"])
    if LAUNCHES.get("target_assign") != steps:
        raise AssertionError(f"the graph must launch target_assign once per step ({steps}), got {LAUNCHES.snapshot()}")
    graph_state = clone()
    restore_state(trainer, start)
    eager_rows = []

    def eager_step(s):
        metrics = trainer.step_fn(trainer.data, fixed_batch(trainer, s), None, None)
        eager_rows.append(torch.stack([metrics[k] for k in METRIC_NAMES]))
        return metrics

    eager_gaps = hold_to_reference(reference, eager_step, "eager training")
    ref_bits = {"losses_bit_equal": torch.equal(graph.metrics[:steps], torch.stack(eager_rows)),
                "state": state_gap(graph_state, clone())}

    # 2. does the eager step repeat itself?
    def gradients():
        restore_state(trainer, start)
        bundle = trainer.step_fn.losses(trainer.step_fn.prepare(trainer.data, fixed_batch(trainer, 0), None))
        bundle.total.backward()
        grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters() if p.grad is not None}
        trainer.optimizer.zero_grad()
        return grads

    first, second = gradients(), gradients()
    repeat = [n for n in first if not torch.equal(first[n], second[n])]

    # 3. deterministic cuDNN: the augmented steps, eager against graph, bit for bit
    rows = np.random.default_rng(5).permutation(len(trainer.train_dataset))[:AB_STEPS * batch]
    rows = rows.reshape(AB_STEPS, batch).astype(np.int64)
    torch.backends.cudnn.deterministic = True
    try:
        restore_state(trainer, start)
        trainer.generator.manual_seed(5)
        eager_aug = []
        for row in rows:
            metrics = trainer.step_fn(trainer.data, torch.from_numpy(row).to(dev), trainer.draws(), trainer.generator)
            eager_aug.append(torch.stack([metrics[k] for k in METRIC_NAMES]))
        eager_state, eager_aug = clone(), torch.stack(eager_aug)
        restore_state(trainer, start)
        trainer.generator.manual_seed(5)
        aug_graph = ResidentGraph(trainer.step_fn, trainer.data, AB_STEPS + TURN_STEPS)
        LAUNCHES.reset()
        for row in rows:
            aug_graph(torch.from_numpy(row), trainer.draws(), trainer.generator)
        aug_launches = LAUNCHES.get("target_assign")
        aug_state = state_gap(eager_state, clone())
    finally:
        torch.backends.cudnn.deterministic = False
    aug_equal = torch.equal(aug_graph.metrics[:AB_STEPS], eager_aug)
    if not aug_equal or aug_state["tensors_differing"] or aug_launches != AB_STEPS:
        raise AssertionError(f"with deterministic cuDNN the graphed augmented steps must be the eager ones bit for "
                             f"bit: losses equal {aug_equal}, state {aug_state}, target_assign {aug_launches}")

    # 4. step time in turns: eager and graph with cuDNN's defaults, and the
    # deterministic graph of 3: eager, graph, deterministic, deterministic, graph, eager, ...
    turn_graph = ResidentGraph(trainer.step_fn, trainer.data, TURN_STEPS)
    turn_graph(torch.from_numpy(rows[0]), trainer.draws(), trainer.generator)  # warm-up step and capture
    turn_graph.reset()
    graph_of = {"graph": turn_graph, "deterministic": aug_graph}
    turns = {"eager": [], "graph": [], "deterministic": []}
    order = [("eager", "graph", "deterministic"), ("deterministic", "graph", "eager")] * (TURN_STEPS // 2)
    for i, path in enumerate(p for triple in order for p in triple):
        row, draws = rows[i % AB_STEPS], trainer.draws()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if path == "eager":
            trainer.step_fn(trainer.data, torch.from_numpy(row).to(dev), draws, trainer.generator)
        else:
            graph_of[path](torch.from_numpy(row), draws, trainer.generator)
        torch.cuda.synchronize()
        turns[path].append((time.perf_counter() - t0) * 1e3)
    del aug_graph, graph_of
    return {
        "reference_max_rel_gap": graph_gaps, "reference_steps": ref_steps,
        "reference_max_rel_gap_eager": eager_gaps, "reference_graph_s": ref_graph_s,
        "reference_graph_against_eager": ref_bits,
        "eager_backward_twice_leaves_differing": len(repeat), "eager_backward_twice_first": repeat[:3],
        "deterministic_augmented_steps": AB_STEPS, "deterministic_bit_equal": True,
        "target_assign_per_replay": aug_launches / AB_STEPS,
        "turns_step_ms": turns,
        "turns_step_ms_p50": {k: float(np.median(v)) for k, v in turns.items()},
        "turns_graph_over_eager": float(np.median(turns["graph"]) / np.median(turns["eager"])),
        "turns_deterministic_over_default_graph": float(np.median(turns["deterministic"])
                                                        / np.median(turns["graph"])),
    }


VARIANT_AB_STEPS = 3  # a variant's graph against its eager step: steps of each from one state
VARIANT_TURNS = 2  # a variant's step times in turns: steps of each path
VARIANT_GRAPH_ROWS = VARIANT_AB_STEPS + VARIANT_TURNS + 1  # and one profiled replay


def graph_pool_mb(graph, device) -> float:
    """The memory pool of a step's graph (a ``ResidentGraph`` or ``HostGraph``,
    or a ``TimedGraph`` of one), MB."""
    from hmd_ego_pose_tpu_torch.utils import graphs

    graph = graph.graph if isinstance(graph, TimedGraph) else graph
    return graphs.pool_bytes(graph.graph.graph.pool(), device) / 1e6


def index_rows(frames: int, batch: int, steps: int = VARIANT_AB_STEPS, seed: int = 5) -> list:
    """``steps`` seeded (batch,) index rows into ``frames`` frames, host int64 tensors."""
    import numpy as np
    import torch

    rows = np.random.default_rng(seed).permutation(frames)[:steps * batch].reshape(steps, batch)
    return [torch.from_numpy(r) for r in rows.astype(np.int64)]


def profiled_calls(fn) -> dict:
    """One call of ``fn`` under torch.profiler: the kernels it ran, the launch,
    graph-launch and copy calls the host made, and the profile's seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    kernels = sum(e.count for e in on_device(averages) if not e.key.startswith(("Memcpy", "Memset")))
    return {"kernels_per_step": kernels, **launch_calls(averages, 1, "step"), "profile_s": time.perf_counter() - t0}


def variant_graph_against_eager(trainer, graph, sources, eager_step, drop: bool = True,
                                turns: int = VARIANT_TURNS, profile: bool = True) -> dict:
    """A training variant's graph against its eager step, from the trainer's
    state, with ``torch.backends.cudnn.deterministic``:

    1. the steps of ``sources`` (each step's source: an index row on the host
       or a host pipeline's batch) through ``eager_step(source, draws,
       generator)``, then from the same state through ``graph`` (a new
       ``ResidentGraph`` or ``HostGraph`` of the trainer's step, with rows for
       every step here), the trainer's generator seeded alike, so that both
       take the same draws and drop-connect masks (``drop``): the losses and
       every parameter and BN buffer bit-equal, ``target_assign`` once a
       step, or the phase fails;
    2. ``turns`` (even) steps of each in turns (eager, graph, graph, eager),
       each synchronised and timed, both still with deterministic cuDNN;
    3. with ``profile``, one more replay under torch.profiler: its kernels
       and the launch, graph-launch and copy calls of the host;
    4. the graph's memory pool and the peak memory of 1-3.

    ``steps`` in the result counts the steps run (each launches
    ``target_assign`` once, counted in ``kernels.LAUNCHES``)."""
    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.ops.augment_device import Batch
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES

    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    generator = trainer.generator if drop else None

    def draws(source):  # a host-augmented batch takes none
        return None if isinstance(source, Batch) else trainer.draws()

    def eager_losses(*args):
        metrics = eager_step(*args)
        return torch.stack([metrics[k] for k in METRIC_NAMES])

    def run(step):
        restore_state(trainer, start)
        trainer.generator.manual_seed(5)
        out = [step(source, draws(source), generator) for source in sources]
        torch.cuda.synchronize()
        return out, {k: v.clone() for k, v in trainer.model.state_dict().items()}

    n, rows = len(sources), len(sources) + turns + int(profile)
    if graph.steps < rows or graph.graph is not None:
        raise ValueError(f"a new graph with rows for {rows} steps, got {graph.steps}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counted = LAUNCHES.get("target_assign")
    torch.backends.cudnn.deterministic = True
    try:
        eager_rows, eager_state = run(eager_losses)
        _, graph_state = run(graph)
        launches = LAUNCHES.get("target_assign") - counted
        equal = torch.equal(graph.metrics[:n], torch.stack(eager_rows))
        gap = state_gap(eager_state, graph_state)
        if not equal or gap["tensors_differing"] or launches != 2 * n:
            raise AssertionError(f"with deterministic cuDNN the graphed steps must be the eager ones bit for bit: "
                                 f"losses equal {equal}, state {gap}, target_assign {launches} for {2 * n} steps")
        times = {"eager": [], "graph": []}
        order = [("eager", "graph"), ("graph", "eager")] * (turns // 2)
        for i, path in enumerate(p for pair in order for p in pair):
            source = sources[i % n]
            step = eager_step if path == "eager" else graph
            given = draws(source)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(source, given, generator)
            torch.cuda.synchronize()
            times[path].append((time.perf_counter() - t0) * 1e3)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        calls = None
        if profile:
            given = draws(sources[0])
            counted = LAUNCHES.get("target_assign")
            calls = profiled_calls(lambda: graph(sources[0], given, generator))
            calls["target_assign"] = LAUNCHES.get("target_assign") - counted
    finally:
        torch.backends.cudnn.deterministic = False
    if calls is not None and (calls["launch_calls_per_step"] != 0 or calls["graph_launches_per_step"] != 1
                              or calls["target_assign"] != 1):
        raise AssertionError(f"a replay must make no kernel launch call, one graph launch and count target_assign "
                             f"once: {calls}")
    out = {
        "steps": 2 * n + 2 * turns + int(profile), "deterministic_steps": n, "deterministic_bit_equal": True,
        "target_assign_per_step": launches / (2 * n), "graph_pool_mb": graph_pool_mb(graph, trainer.device),
        "peak_mem_gb": peak_gb, "profiled_replay": calls,
    }
    if turns:
        out.update(turns_step_ms=times, turns_step_ms_p50={k: float(np.median(v)) for k, v in times.items()},
                   turns_graph_over_eager=float(np.median(times["graph"]) / np.median(times["eager"])))
    return out


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
    # drop-connect off, fixed batches, against the JAX package's losses, eager
    # and through the step's graph; then graph against eager, augmented
    with contextlib.redirect_stdout(quiet):
        ref_trainer = cli.build_trainer(args, logger=MetricLogger(os.path.join(work, "runs"), stdout=False),
                                        checkpoint_dir=os.path.join(work, "ref_ckpt"))
    graph_ab = graph_against_eager(ref_trainer, reference)
    ref_gaps, ref_steps = graph_ab.pop("reference_max_rel_gap"), graph_ab.pop("reference_steps")
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
    if not trainer.graphed:
        raise AssertionError("cli train's resident trainer on the card must replay its step's CUDA graph")
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
    if getattr(trainer.predict_fn, "captures", None) != 1:
        raise AssertionError("validation on the card must predict through one graph captured once, got "
                             f"{trainer.predict_fn!r}")

    t_profile = time.perf_counter()
    profile = profile_steps(trainer)
    profile["profile_s"] = time.perf_counter() - t_profile
    colour = colour_fixed_against_grouped(trainer.device)
    train_metrics, result = run["epochs"][-1]
    return {
        "reference_max_rel_gap": ref_gaps, "reference_tolerance_rel": reference["tolerance_rel"],
        "reference_steps": ref_steps, "graph_against_eager": graph_ab, "graphed": trainer.graphed,
        "colour_fixed_against_grouped": colour, "eval_captures": trainer.predict_fn.captures,
        **timed.summary(batch), "batch": batch, "frames": frames,
        "val_frames": len(trainer.val_dataset),
        "startup_s": t_startup, "fit_s": run["fit_s"], "epoch_s": train_metrics["epoch_seconds"],
        "validate_s": run["val_s"][0] if run["val_s"] else None, "profile": profile,
        "epoch_means": {k: train_metrics[k] for k in METRIC_NAMES},
        "val_mixed_point_distance_mean_mm": result.scalars()["mixed_point_distance_mean_mm"],
        "launches": launches, "backbone_stats_moved": len(stats_moved), **saved,
        "peak_mem_gb": peak_gb, "card": card,
    }


# train_dp's augmented epoch, cut to keep the script's time
DP_AUG_STEPS = 2
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
    from hmd_ego_pose_tpu_torch.parallel.mesh import batch_sharding, state_digest
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
    if trainer.graphed != (not shared):
        raise AssertionError(f"rank {rank}: an NCCL mesh's step must be graphed, a gloo mesh's eager: "
                             f"graphed {trainer.graphed} over {dist.get_backend()}")
    if trainer.graphed:
        trainer.graph.reset()
    for s in range(4):
        rows = batch_sharding(trainer.mesh)(fixed_batch(trainer, s))
        if trainer.graphed:  # NCCL, a card per rank: the step's graph, its collectives inside
            trainer.graph(rows.cpu(), None, None)
            metrics = dict(zip(METRIC_NAMES, trainer.graph.metrics[s]))
        else:
            metrics = trainer.step_fn(trainer.data, rows, None, None)
        fixed.append({k: float(metrics[k]) for k in METRIC_NAMES})
        digests.append(state_digest(trainer.model))
    out.update(fixed=fixed, fixed_digests=digests, graphed=trainer.graphed)
    if shared:
        # fit runs the trainer's own epoch code, its epoch cut to the first
        # DP_AUG_STEPS index rows the sampler draws
        timed = DigestStep(trainer.step_fn, trainer.model)
        trainer.step_fn = timed
        epoch_indices = trainer.pipeline.epoch_indices
        trainer.pipeline.epoch_indices = lambda oversample=1: epoch_indices(oversample)[:DP_AUG_STEPS]
        epochs = []
        trainer.predict_fn = RecordingForward(trainer.predict_fn)  # rank 0's validation, graphed
        validate, val_s = trainer.validate, []

        def timed_validate(*a, **kw):
            t = time.perf_counter()
            result = validate(*a, **kw)
            val_s.append(time.perf_counter() - t)
            return result

        trainer.validate = timed_validate
        trainer.mesh.stats.reset()
        t = time.perf_counter()
        best = trainer.fit(epochs=1, on_epoch_end=lambda epoch, metrics, result: epochs.append(metrics))
        fit_s = time.perf_counter() - t
        if rank == 0:  # its last batch replayed and eager: bit-equal, one capture
            out["eval_graph"] = eval_graph_against_eager(trainer.predict_fn.forward, trainer.predict_fn.calls[-1:])
            out["validate_s"] = val_s[0]
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


def start_ranks(flag: list, work: str, tag: str, args: list, world: int = 2) -> list:
    """``world`` ranks of this script (``flag`` then ``<work>/<tag>_rank<r>``
    then ``args``) as subprocesses, under torchrun's environment on a free
    127.0.0.1 port."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(world):
        rank_work = os.path.join(work, f"{tag}_rank{rank}")
        os.makedirs(rank_work, exist_ok=True)
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                   RANK=str(rank), LOCAL_RANK=str(rank), PYTHONPATH=HERE)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), *flag, rank_work, *args],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                      cwd=rank_work))
    return procs


def start_dp_ranks(mode: str, data: str, work: str, go: str = "") -> list:
    """Two ranks of ``train_dp_rank`` as subprocesses of this script (a free
    127.0.0.1 port, torchrun's environment), waiting for ``go`` after their
    start-up if it is given."""
    return start_ranks(["--train-dp-rank", mode, data], work, mode, [go])


def join_dp_ranks(mode: str, procs: list, timeout: float = DP_RANK_TIMEOUT_S) -> list:
    """Joins ``start_ranks``' ranks, each within ``timeout`` seconds from now
    and killed past it; a rank that fails or times out raises.  Returns each
    rank's JSON line."""
    deadline, results, failed = time.monotonic() + timeout, [], []
    try:
        for rank, proc in enumerate(procs):
            try:
                stdout, stderr = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
                failed.append(f"rank {rank} timed out after {timeout} s:\n{stderr[-3000:]}")
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
        raise AssertionError(f"ranks ({mode}) failed:\n" + "\n".join(failed))
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
    if "eval_graph" not in zero or "eval_graph" in one:
        raise AssertionError("rank 0, and only rank 0, validates through one captured graph")
    nccl = "not run: 1 card"
    if torch.cuda.device_count() >= 2:
        # the fixed steps through the step's graph, its NCCL collectives inside, one card per rank
        nccl_ranks = join_dp_ranks("nccl", start_dp_ranks("nccl", data, os.path.join(work, "dp_nccl")))
        if (nccl_ranks[0]["backend"] != "nccl" or nccl_ranks[1]["device"] != "cuda:1"
                or not all(r["graphed"] for r in nccl_ranks)):
            raise AssertionError(f"not graphed NCCL across cards: "
                                 f"{[(r['backend'], r['device'], r['graphed']) for r in nccl_ranks]}")
        nccl = hold_dp_fixed(nccl_ranks, reference, train["reference_steps"])
        nccl["graphed"] = True
    aug = zero["augmented"]
    return {
        **held, "ranks": 2, "backend": "gloo", "shared_card": True, "batch_per_rank": 8,
        "augmented": aug, "single_process_step_ms_p50": train["step_ms_p50"],
        "step_vs_single_process": aug["step_ms_p50"] / train["step_ms_p50"],
        "collective_calls_per_step": zero["collective_calls_per_step"],
        "collective_ms_per_step": zero["collective_ms_per_step"],
        "collective_share_of_step": zero["collective_share_of_step"],
        "validation_graph": zero["eval_graph"], "validate_s": zero["validate_s"],
        "single_process_validate_s": train["validate_s"],
        "fit_s": zero["fit_s"], "startup_s": [r["startup_s"] for r in ranks], "ranks_s": run_s,
        "waited_s": [r["waited_s"] for r in ranks],
        "val_metric_broadcast": zero["plateau"]["best"],
        "launches": {"target_assign": sum(r["launches"].get("target_assign", 0) for r in ranks)},
        "launches_per_rank": [r["launches"] for r in ranks], "nccl": nccl, "card": card,
    }


def probe_mesh(device):
    """A ``DataMesh`` of one rank (``ProbeMesh``) whose every collective goes
    through ``torch.distributed`` even at size 1, so that a step's real
    collective sequence is made, and captured, on a one-rank NCCL group."""
    from hmd_ego_pose_tpu_torch.parallel.mesh import DataMesh

    class ProbeMesh(DataMesh):
        def _live(self, size: int) -> bool:
            return True

    return ProbeMesh(rank=0, world=1, device=device, backend="nccl")


def probe_space_mesh(device):
    """A ``DataMesh`` of one rank (``ProbeSpaceMesh``) that acts as data 1 x
    space 2 at space rank 0: each collective over the space group or over
    (data x space) is made as a real call of this process's one-rank group,
    so a spatial step's or predict's collectives are made, and captured, on
    a one-rank NCCL group, and the absent rank 1 is stood in for by a mirror
    of this one: an all-gather returns this rank's part twice, a sum over
    the group twice this rank's value, so the mean over (data x space) the
    value.  The data axis (one rank) makes none, as a real rank's does not.
    What it computes is well defined (the slab below this one is its
    mirror), but it is not the two-rank function: it holds the capture of
    the spatial code (halos, gathered heads, space sums, BN over the
    (data x space) group), not its numbers."""
    import torch.distributed as dist

    from hmd_ego_pose_tpu_torch.parallel.mesh import DataMesh

    class ProbeSpaceMesh(DataMesh):
        def _all_gather(self, tensor, kind, group, size):
            (part,) = super()._all_gather(tensor, kind, group, 1)
            return [part] * size

        def all_reduce_sum_(self, tensor, kind, over="data"):
            super().all_reduce_sum_(tensor, kind, over)
            size = self._axis(over)[1]
            if size > 1:
                tensor.mul_(size)
            return tensor

    return ProbeSpaceMesh(rank=0, world=1, device=device, space=2, space_rank=0, backend=dist.get_backend())


MESH_GRAPH_STEPS = 4  # fixed steps of each path from one state
MESH_GRAPH_TURNS = 4  # graphed steps of the probe mesh and of one process, each, in turns
MESH_GRAPH_TIMEOUT_S = 240
STEP_KINDS = ("bn", "bn_backward", "grads", "metrics")  # a train step's collectives


def mesh_graph_rank(data: str, work: str, go: str, space_go: str) -> dict:
    """The mesh_graph phase's process (``chip_smoke.py --mesh-graph-rank WORK
    DATA GO`` under torchrun's environment, world 1): one NCCL rank on card
    0.  ``cli train``'s trainer is built on ``probe_mesh`` (it makes every
    collective at one rank); once ``GO`` exists, with deterministic cuDNN,
    ``MESH_GRAPH_STEPS`` fixed steps from one state (augmentation and
    drop-connect off) eagerly on the probe mesh, through the trainer's step
    graph (its collectives inside) and through a single-process step's
    graph: losses and state bit-equal, the graph's collectives by kind those
    of the eager step, the losses within the JAX reference's tolerance; the
    two graphs' replays in turns; one replay profiled (launch calls, graph
    launches, ``target_assign``, collectives); then engines at batch 1 and
    2 on the probe mesh and in one process (``engine_graphs``) answering the
    six golden frames, bit-equal to each other; it writes ``GO.data_done``;
    then, once ``SPACE_GO`` exists, the space probe (``space_probe``) on the
    same group."""
    import collections
    from types import SimpleNamespace

    import numpy as np
    import torch
    import torch.distributed as dist

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.config import ModelConfig, ServingConfig
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
    from hmd_ego_pose_tpu_torch.models.weights import from_jax_params
    from hmd_ego_pose_tpu_torch.parallel import distributed
    from hmd_ego_pose_tpu_torch.parallel import mesh as mesh_mod
    from hmd_ego_pose_tpu_torch.serving.engine import InferenceEngine
    from hmd_ego_pose_tpu_torch.train.checkpoint import meta_hand_relative, restore_checkpoint
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES, ResidentGraph, TrainStep
    from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

    t0 = time.perf_counter()
    distributed.initialize("cuda:0", timeout=120.0)
    dev = torch.device("cuda", 0)
    probe = probe_mesh(dev)
    mesh_mod.make_mesh = lambda *a, **kw: probe  # cli.build_trainer's mesh
    args = cli.build_parser().parse_args(["train", "--dataset-path", data, "--ckpt", ARTIFACT, "--epo", "1",
                                          "--device", "cuda:0"])
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = cli.build_trainer(args, logger=MetricLogger(os.path.join(work, "runs"), stdout=False),
                                    checkpoint_dir=os.path.join(work, "ckpt"))
    params, bn_state, meta = restore_checkpoint(ARTIFACT, dev)
    golden, frames, cameras = read_golden()
    out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    if trainer.mesh is not probe or not trainer.graphed or out["backend"] != "nccl":
        raise AssertionError(f"the probe trainer must be graphed on a one-rank NCCL mesh: {out}")
    step, batch = trainer.step_fn, trainer.config.train.batch_size
    single = TrainStep(trainer.model, trainer.config, step.model_points.cpu().numpy(), dev,
                       symmetric=step.symmetric, mesh=mesh_mod.LOCAL)
    fixed = [torch.arange(batch * s, batch * (s + 1)) for s in range(MESH_GRAPH_STEPS)]
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    def restore(optimizer):
        restore_state(SimpleNamespace(model=trainer.model, optimizer=optimizer), start)

    def state():
        torch.cuda.synchronize()
        return {k: v.clone() for k, v in trainer.model.state_dict().items()}

    # one eager step, undone: the process's first step (its kernels' loading,
    # deterministic cuDNN's plans) belongs to its start-up, not to the phase
    torch.backends.cudnn.deterministic = True
    try:
        step(trainer.data, fixed[0].to(dev), None, None)
    finally:
        torch.backends.cudnn.deterministic = False
    restore(step.optimizer)
    torch.cuda.synchronize()
    out["startup_s"] = time.perf_counter() - t0
    t0, cpu0 = time.perf_counter(), time.process_time()
    while not os.path.exists(go):
        if time.perf_counter() - t0 > MESH_GRAPH_TIMEOUT_S:
            raise TimeoutError(f"no {go} after {MESH_GRAPH_TIMEOUT_S} s")
        time.sleep(0.05)
    # the host CPU seconds this idle process (its NCCL group's threads among them) took while the others ran
    out.update(waited_s=time.perf_counter() - t0, waited_cpu_s=time.process_time() - cpu0)
    t_phase = time.perf_counter()

    torch.backends.cudnn.deterministic = True
    try:
        # 1. eager on the probe mesh: the step's collectives, made one by one
        restore(step.optimizer)
        probe.stats.reset()
        eager_rows, eager_ms = [], []
        for idx in fixed:
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = step(trainer.data, idx.to(dev), None, None)
            eager_rows.append(torch.stack([metrics[k] for k in METRIC_NAMES]))
            torch.cuda.synchronize()
            eager_ms.append((time.perf_counter() - t) * 1e3)
        eager_state, eager_calls = state(), dict(probe.stats.calls)
        # 2. the trainer's step graph on the probe mesh: a warm-up step, then replays
        restore(step.optimizer)
        graph = ResidentGraph(step, trainer.data, MESH_GRAPH_STEPS + MESH_GRAPH_TURNS + 1)
        LAUNCHES.reset()
        probe.stats.reset()
        for idx in fixed:
            graph(idx, None, None)
        graph_state, graph_calls = state(), dict(probe.stats.calls)
        graph_launches = LAUNCHES.get("target_assign")
        tally = dict(collections.Counter(kind for _, kind in graph.graph.collectives))
        # 3. the single-process step's graph from the same state (the BNs on no mesh)
        mesh_mod.attach(mesh_mod.LOCAL, trainer.model)
        restore(single.optimizer)
        local = ResidentGraph(single, trainer.data, MESH_GRAPH_STEPS + MESH_GRAPH_TURNS)
        for idx in fixed:
            local(idx, None, None)
        local_state = state()
        mesh_mod.attach(probe, trainer.model)
        if local.graph.collectives:
            raise AssertionError(f"the single-process graph holds collectives: {local.graph.collectives[:3]}")
        # 4. the two graphs' replays in turns: probe, one process, one process, probe, ...
        turns = {"probe_mesh": [], "single_process": []}
        order = [("probe_mesh", "single_process"), ("single_process", "probe_mesh")] * (MESH_GRAPH_TURNS // 2)
        for i, path in enumerate(p for pair in order for p in pair):
            torch.cuda.synchronize()
            t = time.perf_counter()
            (graph if path == "probe_mesh" else local)(fixed[i % MESH_GRAPH_STEPS], None, None)
            torch.cuda.synchronize()
            turns[path].append((time.perf_counter() - t) * 1e3)
        # 5. one replay profiled, its collectives counted by the tally
        probe.stats.reset()
        counted = LAUNCHES.get("target_assign")
        calls = profiled_calls(lambda: graph(fixed[0], None, None))
        calls["target_assign"] = LAUNCHES.get("target_assign") - counted
        calls["collectives"] = dict(probe.stats.calls)
        calls["collective_seconds"] = dict(probe.stats.seconds)
    finally:
        torch.backends.cudnn.deterministic = False
    want = torch.stack(eager_rows)
    bits = {"eager_vs_graph_losses": torch.equal(graph.metrics[:MESH_GRAPH_STEPS], want),
            "eager_vs_graph_state": state_gap(eager_state, graph_state),
            "graph_vs_single_losses": torch.equal(graph.metrics[:MESH_GRAPH_STEPS],
                                                  local.metrics[:MESH_GRAPH_STEPS]),
            "graph_vs_single_state": state_gap(graph_state, local_state)}
    if not (bits["eager_vs_graph_losses"] and bits["graph_vs_single_losses"]
            and not bits["eager_vs_graph_state"]["tensors_differing"]
            and not bits["graph_vs_single_state"]["tensors_differing"]):
        raise AssertionError(f"with deterministic cuDNN the probe mesh's graph must be its eager step and the "
                             f"single-process graph bit for bit: {bits}")
    per_step = {k: v / MESH_GRAPH_STEPS for k, v in eager_calls.items()}
    if (tally != per_step or graph_calls != eager_calls or graph_launches != MESH_GRAPH_STEPS
            or sorted(tally) != sorted(STEP_KINDS)):
        raise AssertionError(f"the graph's collectives {tally} (over its steps {graph_calls}) must be the eager "
                             f"step's {per_step} ({eager_calls}); target_assign {graph_launches}")
    if (calls["launch_calls_per_step"] != 0 or calls["graph_launches_per_step"] != 1 or calls["target_assign"] != 1
            or calls["collectives"] != tally or any(calls["collective_seconds"].values())):
        raise AssertionError(f"a replay must make no kernel launch call, one graph launch, count target_assign "
                             f"once and its collectives {tally} without host seconds: {calls}")
    with open(TRAIN_REFERENCE) as f:
        reference = json.load(f)
    rows = iter(graph.metrics[:MESH_GRAPH_STEPS].tolist())
    ref_gaps = hold_to_reference(reference, lambda s: dict(zip(METRIC_NAMES, next(rows))), "probe-mesh graphed")
    out.update(
        steps=MESH_GRAPH_STEPS, deterministic_bit_equal=True, reference_max_rel_gap=ref_gaps,
        collectives_per_replay=tally, collectives_eager_per_step=per_step,
        eager_probe_step_ms=eager_ms, eager_probe_step_ms_p50=float(np.median(eager_ms[1:])),
        turns_step_ms=turns, turns_step_ms_p50={k: float(np.median(v)) for k, v in turns.items()},
        probe_over_single_graph=float(np.median(turns["probe_mesh"]) / np.median(turns["single_process"])),
        profiled_replay=calls, graph_pool_mb=graph_pool_mb(graph, dev))
    del graph, local, single
    torch.cuda.empty_cache()

    # 6. the engine's graphs on the probe mesh (broadcasts, predict, gather) and in one process
    cfg = ModelConfig(phi=0, image_size=256, compute_dtype="bfloat16", hand_relative=bool(meta_hand_relative(meta)))
    serving = ServingConfig(max_batch_size=2, score_threshold=0.1)
    engines, held, poses = {}, {}, {}
    for name, mesh in (("probe_mesh", probe), ("single_process", mesh_mod.LOCAL)):
        model = HMDEgoPose(cfg).to(dev).eval()
        model.load_state_dict(from_jax_params(params, bn_state, cfg), strict=True)
        engine = engines[name] = InferenceEngine(model, cfg, serving, frame_shape=frames.shape[1:3], device=dev,
                                                 mesh=mesh)
        engine.warmup()
        if engine.capture_mode != "batch" or sorted(engine.graphs) != [1, 2]:
            raise AssertionError(f"{name}: the engine must hold whole-batch graphs at 1 and 2, "
                                 f"got {engine.capture_mode} {sorted(engine.graphs)}")
        held[name] = engine_graphs(engine, frames)
        mesh.stats.reset()
        answers = [engine._to_host(engine._dispatch_device(frames[i:i + 1], cameras[i:i + 1]))
                   for i in range(len(frames))]
        answers += [engine._to_host(engine._dispatch_device(frames[i:i + 2], cameras[i:i + 2]))
                    for i in range(0, len(frames), 2)]
        held[name]["collectives_six_frames_and_three_pairs"] = dict(mesh.stats.calls)
        poses[name] = answers
    same = all(np.array_equal(a, b) for p, q in zip(poses["probe_mesh"], poses["single_process"])
               for a, b in zip(p, q))
    found = sum(int(p[0][0]) > 0 for p in poses["probe_mesh"][:len(frames)])
    if not same or found != len(frames) or engines["probe_mesh"].eager_batches:
        raise AssertionError(f"the probe mesh's engine graphs must answer every golden frame as the "
                             f"single-process engine's: equal {same}, detections {found} of {len(frames)}")
    if held["probe_mesh"]["collectives_six_frames_and_three_pairs"] != {"engine": 3 * (len(frames) + 3)}:
        raise AssertionError(f"each replay must count its two broadcasts and its gather: {held['probe_mesh']}")
    out.update(engine=held, engine_poses_bit_equal=True, engine_frames=len(frames))
    del engines
    torch.cuda.empty_cache()

    out["phase_s"] = time.perf_counter() - t_phase
    with open(go + ".data_done", "w"):
        pass

    # 7. the space axis under capture: the space probe (data 1 x space 2, rank 1 mirrored)
    t0 = time.perf_counter()
    while not os.path.exists(space_go):
        if time.perf_counter() - t0 > SPACE_PROBE_WAIT_S:
            raise TimeoutError(f"no {space_go} after {SPACE_PROBE_WAIT_S} s")
        time.sleep(0.05)
    out["space_probe_waited_s"] = time.perf_counter() - t0
    out["space_probe"] = space_probe(trainer, fixed, params, bn_state, meta, frames, cameras, dev)
    out["launches"] = LAUNCHES.snapshot()
    dist.destroy_process_group()
    return out


SPACE_PROBE_STEPS = 4  # fixed fp32 steps of the space probe from one state, eager and graphed
SPACE_PROBE_WAIT_S = 600  # the space probe's wait for its go (it runs beside the export phase)
SPACE_PROBE_TURNS = 2  # graphed and eager space-probe steps, each, in turns


def space_probe(trainer, fixed: list, params, bn_state, meta, frames, cameras, dev) -> dict:
    """The space axis under capture on one card, in the mesh_graph process
    (its one-rank NCCL group), on ``probe_space_mesh`` (data 1 x space 2 at
    space rank 0, the absent rank mirrored), with ``cudnn.deterministic``:

    (a) ``SPACE_PROBE_STEPS`` fixed fp32 steps of ``cli train``'s trainer's
        model (batch 16, the rank's slab of 128 rows) from one state,
        eagerly and through the step's graph (``ResidentGraph``: halos,
        gathered heads, space sums and BN over (data x space) inside):
        losses and every parameter and BN buffer bit-equal, the graph's
        collectives by kind those of the eager step, ``target_assign`` once
        a step; graphed and eager steps in turns; one replay profiled (0
        kernel launch calls, one graph launch, ``target_assign`` once, the
        collectives counted with no host seconds);
    (b) the mesh engine at batch 1 (bf16): its replay of the golden frames
        bit-equal to its eager ``_predict``, two batches in flight keeping
        their answers (``engine_graphs``); the six frames through the graph
        and eagerly (the graphs set aside) in turns, bit-equal, ms of each;
    (c) the fp32 eval forward of the six frames (``make_eval_forward``):
        one capture, two replays, bit-equal to its eager predict."""
    import collections
    from types import SimpleNamespace

    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch.config import Config, ModelConfig, ServingConfig
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
    from hmd_ego_pose_tpu_torch.models.weights import from_jax_params
    from hmd_ego_pose_tpu_torch.ops.preprocess import preprocess_uint8_batch
    from hmd_ego_pose_tpu_torch.parallel import mesh as mesh_mod
    from hmd_ego_pose_tpu_torch.serving.engine import InferenceEngine
    from hmd_ego_pose_tpu_torch.train.checkpoint import meta_hand_relative
    from hmd_ego_pose_tpu_torch.train.step import (METRIC_NAMES, EvalForward, ResidentGraph, TrainStep,
                                                   make_eval_forward)
    from hmd_ego_pose_tpu_torch.utils import graphs

    t0 = time.perf_counter()
    space = probe_space_mesh(dev)
    model = trainer.model
    start = {k: v.clone() for k, v in model.state_dict().items()}
    mesh_mod.attach(space, model)
    step = TrainStep(model, trainer.config, trainer.step_fn.model_points.cpu().numpy(), dev,
                     symmetric=trainer.step_fn.symmetric, mesh=space)
    if not (space.capturable and step.graphable):
        raise AssertionError("the space probe's step must be graphable on a one-rank NCCL group")

    def restore():
        restore_state(SimpleNamespace(model=model, optimizer=step.optimizer), start)

    def state():
        torch.cuda.synchronize()
        return {k: v.clone() for k, v in model.state_dict().items()}

    torch.backends.cudnn.deterministic = True
    try:
        # (a) eager, then through the graph, from one state
        restore()
        space.stats.reset()
        eager_rows, eager_ms = [], []
        for idx in fixed:
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = step(trainer.data, idx.to(dev), None, None)
            eager_rows.append(torch.stack([metrics[k] for k in METRIC_NAMES]))
            torch.cuda.synchronize()
            eager_ms.append((time.perf_counter() - t) * 1e3)
        eager_state, eager_calls = state(), dict(space.stats.calls)
        restore()
        graph = ResidentGraph(step, trainer.data, SPACE_PROBE_STEPS + SPACE_PROBE_TURNS + 1)
        counted = LAUNCHES.get("target_assign")
        space.stats.reset()
        for idx in fixed:
            graph(idx, None, None)
        graph_state, graph_calls = state(), dict(space.stats.calls)
        graph_launches = LAUNCHES.get("target_assign") - counted
        tally = dict(collections.Counter(kind for _, kind in graph.graph.collectives))
        turns = {"graph": [], "eager": []}
        for i, path in enumerate(["graph", "eager", "eager", "graph"] * (SPACE_PROBE_TURNS // 2)):
            idx = fixed[i % len(fixed)]
            torch.cuda.synchronize()
            t = time.perf_counter()
            graph(idx, None, None) if path == "graph" else step(trainer.data, idx.to(dev), None, None)
            torch.cuda.synchronize()
            turns[path].append((time.perf_counter() - t) * 1e3)
        space.stats.reset()
        counted = LAUNCHES.get("target_assign")
        calls = profiled_calls(lambda: graph(fixed[0], None, None))
        calls["target_assign"] = LAUNCHES.get("target_assign") - counted
        calls["collectives"] = dict(space.stats.calls)
        calls["collective_seconds"] = dict(space.stats.seconds)
        pool_mb = graph_pool_mb(graph, dev)
    finally:
        torch.backends.cudnn.deterministic = False
    want = torch.stack(eager_rows)
    bits = {"losses": torch.equal(graph.metrics[:SPACE_PROBE_STEPS], want),
            "state": state_gap(eager_state, graph_state)}
    if not (bits["losses"] and not bits["state"]["tensors_differing"] and bool(torch.isfinite(want).all())):
        raise AssertionError(f"with deterministic cuDNN the space probe's step graph must be its eager step bit for "
                             f"bit, its losses finite: {bits}")
    per_step = {k: v / SPACE_PROBE_STEPS for k, v in eager_calls.items()}
    if (tally != per_step or graph_calls != eager_calls or graph_launches != SPACE_PROBE_STEPS
            or not {"halo", "halo_backward", "gather", "gather_backward", "space_sum", "bn"} <= set(tally)):
        raise AssertionError(f"the space probe graph's collectives {tally} (over its steps {graph_calls}) must be "
                             f"the eager step's {per_step} ({eager_calls}); target_assign {graph_launches}")
    if (calls["launch_calls_per_step"] != 0 or calls["graph_launches_per_step"] != 1 or calls["target_assign"] != 1
            or calls["collectives"] != tally or any(calls["collective_seconds"].values())):
        raise AssertionError(f"a space probe replay must make no kernel launch call, one graph launch, count "
                             f"target_assign once and its collectives {tally} without host seconds: {calls}")
    out = {"layout": {"data": 1, "space": 2, "space_rank": 0, "mirrored": True}, "steps": SPACE_PROBE_STEPS,
           "timed_beside": "the export phase's host work (torch.export, saves) in the main process",
           "batch": int(fixed[0].numel()), "deterministic_bit_equal": True,
           "collectives_per_replay": tally, "collectives_per_replay_total": sum(tally.values()),
           "eager_step_ms": eager_ms, "turns_step_ms": turns,
           "turns_step_ms_p50": {k: float(np.median(v)) for k, v in turns.items()},
           "graph_over_eager": float(np.median(turns["graph"]) / np.median(turns["eager"])),
           "profiled_replay": calls, "graph_pool_mb": pool_mb}
    del graph, step
    mesh_mod.attach(mesh_mod.LOCAL, model)
    torch.cuda.empty_cache()

    # (b) the mesh engine's batch-1 graph (frame broadcasts, slab, predict with its halos and gathers)
    hand_relative = bool(meta_hand_relative(meta))
    cfgs = {dt: ModelConfig(phi=0, image_size=256, compute_dtype=dt, hand_relative=hand_relative)
            for dt in ("bfloat16", "float32")}

    def model_of(dt):
        m = HMDEgoPose(cfgs[dt]).to(dev).eval()
        m.load_state_dict(from_jax_params(params, bn_state, cfgs[dt]), strict=True)
        return m

    serving = ServingConfig(max_batch_size=1, score_threshold=0.1)
    engine = InferenceEngine(model_of("bfloat16"), cfgs["bfloat16"], serving, frame_shape=frames.shape[1:3],
                             device=dev, mesh=space)
    engine.warmup()
    if engine.capture_mode != "batch" or sorted(engine.graphs) != [1]:
        raise AssertionError(f"the space probe's engine must hold a whole-batch graph at 1, "
                             f"got {engine.capture_mode} {sorted(engine.graphs)}")
    held = engine_graphs(engine, frames)
    graphs_held, ms, answers = engine.graphs, {"graph": [], "eager": []}, {"graph": [], "eager": []}
    space.stats.reset()
    for i in range(len(frames)):
        for path in (("graph", "eager") if i % 2 == 0 else ("eager", "graph")):
            engine.graphs = graphs_held if path == "graph" else {}
            torch.cuda.synchronize()
            t = time.perf_counter()
            answers[path].append(engine._to_host(engine._dispatch_device(frames[i:i + 1], cameras[i:i + 1])))
            ms[path].append((time.perf_counter() - t) * 1e3)
    engine.graphs = graphs_held
    same = all(np.array_equal(a, b) for p, q in zip(answers["graph"], answers["eager"]) for a, b in zip(p, q))
    finite = all(np.all(np.isfinite(a)) for p in answers["graph"] for a in p)
    if not same or not finite or engine.eager_batches:
        raise AssertionError(f"the space probe engine's graph must answer each frame as its eager batch, bit for "
                             f"bit and finite: equal {same}, finite {finite}, eager batches {engine.eager_batches}")
    held.update(frames=len(frames), bit_equal_to_eager=True, frame_ms=ms,
                frame_ms_p50={k: float(np.median(v)) for k, v in ms.items()},
                graph_over_eager=float(np.median(ms["graph"]) / np.median(ms["eager"])),
                collectives_graphed_and_eager_six_frames=dict(space.stats.calls),
                graph_pool_mb=engine.graph_pool_bytes / 1e6)
    out["engine"] = held
    del engine
    torch.cuda.empty_cache()

    # (c) evaluation's predict on the space probe: one graph, bit-equal to eager
    fp32 = model_of("float32")
    mesh_mod.attach(space, fp32)
    forward = make_eval_forward(fp32, Config(model=cfgs["float32"]), dev)
    images = preprocess_uint8_batch(torch.from_numpy(frames).to(dev), 256).cpu().numpy()
    if not isinstance(forward, EvalForward):
        raise AssertionError("on the space probe make_eval_forward must return an EvalForward")
    got = [forward(images, cameras) for _ in range(2)]
    want = forward.eager(images, cameras)
    differing = [f for g in got for f in want._fields if getattr(g, f).tobytes() != getattr(want, f).tobytes()]
    if differing or forward.captures != 1:
        raise AssertionError(f"the space probe's eval graph differs from its eager predict in {differing}; "
                             f"captures {forward.captures}")
    out["eval_forward"] = {"frames": len(frames), "replays": len(got), "captures": forward.captures,
                           "bit_equal": True,
                           "graph_pool_mb": graphs.pool_bytes(forward.graph.graph.pool(), dev) / 1e6}
    out["seconds"] = time.perf_counter() - t0
    return out


def start_mesh_graph(proc: subprocess.Popen, go: str) -> float:
    """The mesh_graph phase's first part: ``go`` lets ``mesh_graph_rank``'s
    process (started before the train phase) run its data-axis probe alone
    on the card; returns the seconds until it has written ``GO.data_done``.
    The process then waits for its space go (``phase_mesh_graph``)."""
    t0 = time.perf_counter()
    with open(go, "w"):
        pass
    while not os.path.exists(go + ".data_done"):
        if proc.poll() is not None:
            join_dp_ranks("mesh_graph", [proc], 1.0)  # raises with the process's errors
            raise AssertionError("the mesh_graph process ended before its data probe was done")
        if time.perf_counter() - t0 > MESH_GRAPH_TIMEOUT_S:
            raise TimeoutError(f"the mesh_graph data probe took over {MESH_GRAPH_TIMEOUT_S} s")
        time.sleep(0.05)
    return time.perf_counter() - t0


def phase_mesh_graph(card: str, proc: subprocess.Popen, dp: dict, data_wall_s: float) -> dict:
    """The mesh_graph phase's end: joins ``mesh_graph_rank``'s process,
    whose space probe the caller let run (its space go) beside the export
    phase's host work.  The data probe graph's collectives by kind equal a
    two-rank gloo mesh's eager step's (``train_dp``)."""
    t0 = time.perf_counter()
    (rank,) = join_dp_ranks("mesh_graph", [proc], MESH_GRAPH_TIMEOUT_S)
    gloo = dp["collective_calls_per_step"]
    if rank["collectives_per_replay"] != gloo:
        raise AssertionError(f"the graph's collectives {rank['collectives_per_replay']} a replay must be the "
                             f"two-rank gloo mesh's eager step's {gloo}")
    return {
        "nccl_world_1": "NCCL moves no data at world 1: the collectives' kernels run and are captured, but no "
                        "byte crosses between cards; NCCL's transport is not measured here",
        **rank, "gloo_two_rank_collectives_per_step": gloo, "wall_s": data_wall_s,
        "space_probe_join_wait_s": time.perf_counter() - t0, "card": card,
    }


SPATIAL_TIMEOUT_S = 300
SPATIAL_SIZE = 256
SPATIAL_BATCH = 2


def spatial_batch(dev):
    """The spatial phase's train batch: that of ``tests/test_parallel_spatial.py``
    at 256 px and batch 2 (seeded images, one fixed object), and its model points."""
    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch.ops.augment_device import Batch

    rng = np.random.RandomState(2)
    b, f = SPATIAL_BATCH, np.float32
    model_points = (rng.normal(size=(1, 64, 3)) * 50).astype(f)
    arrays = (rng.normal(size=(b, SPATIAL_SIZE, SPATIAL_SIZE, 3)).astype(f) * f(0.1),
              np.tile(np.asarray([[570.0, 570.0, 128.0, 128.0, 1000.0, 1.0]], f), (b, 1)),
              np.tile(np.asarray([[[60.0, 80.0, 180.0, 200.0]]], f), (b, 1, 1)), np.zeros((b, 1), np.int32),
              np.tile(np.asarray([[[0.1, 0.2, 0.1, 10.0, -5.0, 500.0, 0.0, 0.0]]], f), (b, 1, 1)),
              np.zeros((b, 1, 63), f), np.ones((b, 1), bool))
    return Batch(*(torch.from_numpy(a).to(dev) for a in arrays)), model_points


def recording_grads(optimizer) -> dict:
    """A dict that the optimizer's next step fills with the gradients as its
    update reads them (after the mesh's all-reduce, before Adam), by index."""
    grads, opt_step = {}, optimizer.opt.step

    def recorded(*args, **kwargs):
        if not grads:
            grads.update({i: p.grad.detach().clone() for i, p in enumerate(optimizer.params)})
        return opt_step(*args, **kwargs)

    optimizer.opt.step = recorded
    return grads


def spatial_rank(work: str, go: str) -> dict:
    """One rank of the spatial phase (``chip_smoke.py --spatial-rank WORK GO``
    under torchrun's environment, two ranks sharing card 0 over gloo): the
    artifact restored (phi-0, 256 px), then, once ``GO`` exists, a data 1 x
    space 2 mesh: the bf16 predict of the six golden frames one frame a call
    on the rank's slabs, held to the goldens; the fp32 raw outputs of the six
    on the mesh against the single-process forward; the engine on the mesh
    (process 0 serves the six frames, process 1 follows) against the
    single-process engine; one fp32 train step at batch 2 against the
    single-process step (losses, gradients before Adam, parameters after).
    Launch counts are read just after the mesh step."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from hmd_ego_pose_tpu_torch.config import Config, ModelConfig, ParallelConfig, ServingConfig, TrainConfig
    from hmd_ego_pose_tpu_torch.eval import golden as hold
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.models import hmd_ego_pose
    from hmd_ego_pose_tpu_torch.models.weights import from_jax_params
    from hmd_ego_pose_tpu_torch.ops.preprocess import preprocess_uint8_batch
    from hmd_ego_pose_tpu_torch.parallel import distributed
    from hmd_ego_pose_tpu_torch.parallel.mesh import make_mesh, replicate, state_digest
    from hmd_ego_pose_tpu_torch.serving.engine import InferenceEngine
    from hmd_ego_pose_tpu_torch.train.checkpoint import meta_hand_relative, restore_checkpoint
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES, TrainStep
    from hmd_ego_pose_tpu_torch.utils.device import resolve_device

    distributed.initialize("cuda:0", shared_device=True, timeout=120.0)
    dev = resolve_device("cuda:0")
    rank = dist.get_rank()
    LAUNCHES.reset()
    t0 = time.perf_counter()
    params, bn_state, meta = restore_checkpoint(ARTIFACT, dev)
    hand_relative = bool(meta_hand_relative(meta))
    cfgs = {dt: ModelConfig(phi=0, image_size=SPATIAL_SIZE, compute_dtype=dt, hand_relative=hand_relative)
            for dt in ("bfloat16", "float32")}

    def model_of(dt):
        model = hmd_ego_pose.HMDEgoPose(cfgs[dt]).to(dev).eval()
        model.load_state_dict(from_jax_params(params, bn_state, cfgs[dt]), strict=True)
        return model

    golden, frames, cameras = read_golden()
    torch.cuda.synchronize()
    out = {"rank": rank, "startup_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    while not os.path.exists(go):
        if time.perf_counter() - t0 > SPATIAL_TIMEOUT_S:
            raise TimeoutError(f"rank {rank}: no {go} after {SPATIAL_TIMEOUT_S} s")
        time.sleep(0.05)
    out["waited_s"] = time.perf_counter() - t0
    t_phase = time.perf_counter()
    mesh = make_mesh(ParallelConfig(spatial_parallel=2), device=dev)
    out.update(coords=[mesh.rank, mesh.model_rank, mesh.space_rank], rows=[mesh.height_rows(SPATIAL_SIZE).start,
                                                                          mesh.height_rows(SPATIAL_SIZE).stop])
    cams = torch.from_numpy(cameras).to(dev)
    whole = preprocess_uint8_batch(torch.from_numpy(frames).to(dev), SPATIAL_SIZE)
    slab = whole[:, mesh.height_rows(SPATIAL_SIZE)]

    # the bf16 predict, one frame a call: the goldens, ms a frame, collectives a forward
    cfg = cfgs["bfloat16"]
    bf16 = model_of("bfloat16")
    replicate(mesh, bf16)
    hmd_ego_pose.apply(bf16, slab[:1], cfg)  # the first call's plans
    torch.cuda.synchronize()
    mesh.stats.reset()
    reports, frame_ms = [], []
    for i in range(len(frames)):
        t = time.perf_counter()
        outputs = hmd_ego_pose.apply(bf16, slab[i:i + 1], cfg)
        dets = hmd_ego_pose.detect(outputs, cams[i:i + 1], cfg, score_threshold=0.1)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        reports.append(hold.hold_frame(hold.top_detection(dets, 0), hold.tied_candidates(outputs, cams[i:i + 1], 0, cfg),
                                       golden, i, hand_relative))
    bad = [r for r in reports if not r["ok"]]
    if bad:
        raise AssertionError(f"rank {rank}: spatial predictions off the goldens: {bad}")
    forward = mesh.stats.snapshot()
    out.update(frame_ms=frame_ms, frame_ms_p50=float(np.median(frame_ms)), worst=hold.worst(reports),
               tie_switches=sum(r["tie_switch"] for r in reports),
               collectives_per_forward={k: v / len(frames) for k, v in forward["calls"].items()},
               collective_ms_per_forward={k: v * 1e3 / len(frames) for k, v in forward["seconds"].items()})

    # the fp32 raw outputs of the six on the mesh against the single-process forward
    names = ("regression", "classification", "rotation", "translation_raw", "hand")
    fp32 = model_of("float32")
    replicate(mesh, fp32)
    got = hmd_ego_pose.apply(fp32, slab, cfgs["float32"])
    want = hmd_ego_pose.apply(model_of("float32"), whole, cfgs["float32"])
    gaps = {}
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if not torch.allclose(a, b, rtol=2e-4, atol=2e-5):
            raise AssertionError(f"rank {rank}: fp32 {name} off the single-process forward by "
                                 f"{float((a - b).abs().max())} (rtol 2e-4, atol 2e-5)")
        gaps[name] = float((a - b).abs().max())
    out["fp32_max_abs_gap"] = gaps

    # the engine on the space-only mesh, then (process 0) the single-process engine
    serving = ServingConfig(max_batch_size=1, score_threshold=0.1)
    engine = InferenceEngine(model_of("bfloat16"), cfg, serving, frame_shape=frames.shape[1:3], device=dev, mesh=mesh)
    out["engine_batch_sizes"] = engine.batch_sizes
    if engine.leader:
        engine.warmup()
        engine.start()
        try:
            t = time.perf_counter()
            poses = [engine.infer_blocking(f, c, timeout=60.0) for f, c in zip(frames, cameras)]
            out["engine_ms_per_frame"] = (time.perf_counter() - t) * 1e3 / len(frames)
        finally:
            engine.stop()
        single = InferenceEngine(model_of("bfloat16"), cfg, serving, frame_shape=frames.shape[1:3], device=dev)
        single.warmup()
        single.start()
        try:
            want_poses = [single.infer_blocking(f, c, timeout=60.0) for f, c in zip(frames, cameras)]
        finally:
            single.stop()
        worst = {"rotation": 0.0, "translation_mm": 0.0}
        for i, (p, q) in enumerate(zip(poses, want_poses)):
            if p is None or q is None:
                raise AssertionError(f"frame {i}: the mesh engine answered {p}, the single-process one {q}")
            bound = hold.bounds(golden, i, hand_relative)
            rot, mm = float(np.abs(p[0] - q[0]).max()), float(np.abs(p[1] - q[1]).max()) * 1e3
            if rot > bound["rotation"] or mm > bound["translation"]:
                raise AssertionError(f"frame {i}: the mesh engine's pose is {rot} rad, {mm} mm off the "
                                     f"single-process engine's (bounds {bound})")
            worst = {"rotation": max(worst["rotation"], rot), "translation_mm": max(worst["translation_mm"], mm)}
        out["engine_vs_single_worst"] = worst
        out["engine_poses"] = [[np.asarray(v, np.float32).tolist() for v in p] for p in poses]
    else:
        out["engine_served"] = engine.follow()

    # one fp32 train step at batch 2 on the mesh, then the single-process step
    batch, model_points = spatial_batch(dev)
    config = Config(model=cfgs["float32"], train=TrainConfig(batch_size=SPATIAL_BATCH, learning_rate=1e-3))
    model = model_of("float32")
    replicate(mesh, model)
    step = TrainStep(model, config, model_points, dev, mesh=mesh)
    grads = recording_grads(step.optimizer)
    t = time.perf_counter()
    metrics = step.update(step.losses(batch))
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t) * 1e3
    out["launches"] = LAUNCHES.snapshot()
    out["losses"] = {k: float(metrics[k]) for k in METRIC_NAMES}
    out["digest"] = state_digest(model)
    reference = model_of("float32")
    single_step = TrainStep(reference, config, model_points, dev)
    want_grads = recording_grads(single_step.optimizer)
    want = single_step.update(single_step.losses(batch))
    out["single_losses"] = {k: float(want[k]) for k in METRIC_NAMES}
    rel = max(abs(out["losses"][k] - out["single_losses"][k]) / max(abs(out["single_losses"][k]), 1e-12)
              for k in METRIC_NAMES)
    # every leaf's gradient after the (data x space) all-reduce, before Adam:
    # within 1e-4 of its norm plus 1e-6 of the global norm G (train_dp's bound)
    g_norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in want_grads.values())))
    grad_ratio = max(float((grads[i] - g).norm()) / (1e-4 * float(g.norm()) + 1e-6 * g_norm)
                     for i, g in want_grads.items())
    ref_state = reference.state_dict()
    gap = max(float((v - ref_state[k]).abs().max()) for k, v in model.state_dict().items()
              if v.dtype.is_floating_point)
    if not (rel <= 1e-5 and grad_ratio <= 1.0 and len(grads) == len(want_grads) > 0 and gap < 5e-3):
        raise AssertionError(f"rank {rank}: the spatial step is {rel:.3g} relative off the single-process losses "
                             f"(<= 1e-5), its gradients {grad_ratio:.3g} of their bound (<= 1), its largest "
                             f"parameter gap {gap:.3g} (< 5e-3)")
    out.update(step_max_rel_loss_gap=rel, step_grad_gap_of_bound=grad_ratio, step_grad_norm=g_norm,
               step_max_param_gap=gap)
    stats = mesh.stats.snapshot()
    out["collectives"] = {"calls": stats["calls"], "ms": {k: v * 1e3 for k, v in stats["seconds"].items()}}
    out["phase_s"] = time.perf_counter() - t_phase
    dist.destroy_process_group()
    return out


def spatial_nccl_rank(work: str) -> dict:
    """One rank of the spatial phase's NCCL block (``chip_smoke.py
    --spatial-nccl-rank WORK`` under torchrun's environment), run where the
    host has two cards: a data 1 x space 2 NCCL mesh, rank r on card r.  The
    bf16 engine at batch 1 captured by both ranks' warm-up (frame
    broadcasts, slab, predict with its halos and gathers, pose gather):
    process 0 serves the six golden frames by replay, held to the goldens
    (with the single-process forward's tied candidates), process 1 follows
    by replay; then, with ``cudnn.deterministic``, the fp32 spatial step at
    batch 2 (``spatial_batch``) eagerly from the artifact, and from the same
    state through the step's graph (``HostGraph``: its first call the
    warm-up step and the capture, then back at the start and one replay):
    losses and state bit-equal to the eager step, the replay's collectives
    by kind the eager step's, ``target_assign`` once a step."""
    import collections
    from types import SimpleNamespace

    import numpy as np
    import torch
    import torch.distributed as dist

    from hmd_ego_pose_tpu_torch.config import Config, ModelConfig, ParallelConfig, ServingConfig, TrainConfig
    from hmd_ego_pose_tpu_torch.eval import golden as hold
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.models import hmd_ego_pose
    from hmd_ego_pose_tpu_torch.models.weights import from_jax_params
    from hmd_ego_pose_tpu_torch.ops.augment_device import Batch
    from hmd_ego_pose_tpu_torch.ops.preprocess import preprocess_uint8_batch
    from hmd_ego_pose_tpu_torch.parallel import distributed
    from hmd_ego_pose_tpu_torch.parallel.mesh import make_mesh, replicate, state_digest
    from hmd_ego_pose_tpu_torch.serving.engine import InferenceEngine
    from hmd_ego_pose_tpu_torch.train.checkpoint import meta_hand_relative, restore_checkpoint
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES, HostGraph, TrainStep

    distributed.initialize(None, timeout=120.0)
    dev = distributed.local_device(None)
    LAUNCHES.reset()
    t0 = time.perf_counter()
    mesh = make_mesh(ParallelConfig(spatial_parallel=2), device=dev)
    if mesh.backend != "nccl" or not mesh.capturable:
        raise AssertionError(f"the NCCL block needs a capturable NCCL mesh: {mesh.backend}, {mesh.device}")
    params, bn_state, meta = restore_checkpoint(ARTIFACT, dev)
    hand_relative = bool(meta_hand_relative(meta))
    cfgs = {dt: ModelConfig(phi=0, image_size=SPATIAL_SIZE, compute_dtype=dt, hand_relative=hand_relative)
            for dt in ("bfloat16", "float32")}

    def model_of(dt):
        model = hmd_ego_pose.HMDEgoPose(cfgs[dt]).to(dev).eval()
        model.load_state_dict(from_jax_params(params, bn_state, cfgs[dt]), strict=True)
        return model

    golden, frames, cameras = read_golden()
    out = {"rank": dist.get_rank(), "device": str(dev), "backend": mesh.backend}

    # the engine's batch-1 graph on both ranks
    cfg = cfgs["bfloat16"]
    engine = InferenceEngine(model_of("bfloat16"), cfg, ServingConfig(max_batch_size=1, score_threshold=0.1),
                             frame_shape=frames.shape[1:3], device=dev, mesh=mesh)
    engine.warmup()
    if engine.capture_mode != "batch" or sorted(engine.graphs) != [1]:
        raise AssertionError(f"the NCCL space mesh's engine must hold a whole-batch graph at 1: "
                             f"{engine.capture_mode} {sorted(engine.graphs)}")
    if engine.leader:
        engine.start()
        try:
            t = time.perf_counter()
            poses = [engine.infer_blocking(f, c, timeout=60.0) for f, c in zip(frames, cameras)]
            out["engine_ms_per_frame"] = (time.perf_counter() - t) * 1e3 / len(frames)
        finally:
            engine.stop()
        if engine.eager_batches or any(p is None for p in poses):
            raise AssertionError(f"the graphed NCCL engine answered {poses} ({engine.eager_batches} eager batches)")
        cams = torch.from_numpy(cameras).to(dev)
        outputs = hmd_ego_pose.apply(model_of("bfloat16"), preprocess_uint8_batch(
            torch.from_numpy(frames).to(dev), SPATIAL_SIZE), cfg)
        reports = [hold.hold_frame({"rotation": p[0], "translation": p[1] * 1000.0},
                                   hold.tied_candidates(outputs, cams, i, cfg), golden, i, hand_relative,
                                   quantities=("rotation", "translation")) for i, p in enumerate(poses)]
        if not all(r["ok"] for r in reports):
            raise AssertionError(f"the graphed NCCL engine's poses off the goldens: {reports}")
        out.update(engine_worst=hold.worst(reports),
                   engine_poses=[[np.asarray(v, np.float32).tolist() for v in p] for p in poses])
    else:
        out["engine_served"] = engine.follow()
    del engine

    # the fp32 step at batch 2: eager, then a replay of its graph from the same state
    batch, model_points = spatial_batch(dev)
    config = Config(model=cfgs["float32"], train=TrainConfig(batch_size=SPATIAL_BATCH, learning_rate=1e-3))
    model = model_of("float32")
    replicate(mesh, model)
    step = TrainStep(model, config, model_points, dev, mesh=mesh)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    host = Batch(*(t.cpu().numpy() for t in batch))
    torch.backends.cudnn.deterministic = True
    try:
        mesh.stats.reset()
        eager = step.update(step.losses(batch))
        eager_losses = torch.stack([eager[k] for k in METRIC_NAMES]).clone()
        torch.cuda.synchronize()
        eager_state, eager_calls = {k: v.clone() for k, v in model.state_dict().items()}, dict(mesh.stats.calls)
        restore_state(SimpleNamespace(model=model, optimizer=step.optimizer), start)
        graph = HostGraph(step, 2)
        graph(host, None, None)  # the warm-up step and the capture
        restore_state(SimpleNamespace(model=model, optimizer=step.optimizer), start)
        graph.reset()
        mesh.stats.reset()
        graph(host, None, None)  # one replay
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    tally = dict(collections.Counter(kind for _, kind in graph.graph.collectives))
    gap = state_gap(eager_state, model.state_dict())
    if not torch.equal(graph.metrics[0], eager_losses) or gap["tensors_differing"]:
        raise AssertionError(f"with deterministic cuDNN the NCCL spatial step's replay must be its eager step bit "
                             f"for bit: losses {graph.metrics[0].tolist()} against {eager_losses.tolist()}, {gap}")
    if tally != eager_calls or dict(mesh.stats.calls) != eager_calls:
        raise AssertionError(f"the replay's collectives {dict(mesh.stats.calls)} (tally {tally}) must be the eager "
                             f"step's {eager_calls}")
    out.update(step_bit_equal=True, losses=dict(zip(METRIC_NAMES, eager_losses.tolist())),
               collectives_per_replay=tally, digest=state_digest(model), launches=LAUNCHES.snapshot(),
               seconds=time.perf_counter() - t0)
    dist.destroy_process_group()
    return out


def start_spatial_ranks(work: str, go: str) -> list:
    """The two ranks of ``spatial_rank``, subprocesses of this script."""
    return start_ranks(["--spatial-rank"], work, "spatial", [go])


def phase_spatial(card: str, procs: list, go: str, work: str) -> dict:
    """The space axis: two ranks of a data 1 x space 2 mesh sharing the card
    over gloo (``spatial_rank``), started before the train phase; ``go`` lets
    them run.  Both ranks' state digests equal after the step.  Where the
    host has two cards, the same mesh on NCCL, one card per rank
    (``spatial_nccl_rank``, working in ``work``): the engine's graph answering
    as the gloo ranks' eager engine within the goldens' bounds, the step's
    graph bit-equal to its eager step; with one card the line says so."""
    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch.eval import golden as hold

    t0 = time.perf_counter()
    with open(go, "w"):
        pass
    ranks = join_dp_ranks("spatial", procs, SPATIAL_TIMEOUT_S)
    zero, one = ranks
    if zero["digest"] != one["digest"] or zero["losses"] != one["losses"]:
        raise AssertionError("the spatial step's ranks differ: losses or parameters and BN buffers not bit-identical")
    if [r["rows"] for r in ranks] != [[0, SPATIAL_SIZE // 2], [SPATIAL_SIZE // 2, SPATIAL_SIZE]]:
        raise AssertionError(f"expected two slabs of {SPATIAL_SIZE // 2} rows: {[r['rows'] for r in ranks]}")
    if one.get("engine_served") != len(zero["frame_ms"]) + 1:  # the six frames and the warm-up
        raise AssertionError(f"the follower served {one.get('engine_served')} batches")
    for r in ranks:
        if r["launches"].get("dequantize", 0) != 1 or r["launches"].get("target_assign", 0) != 1:
            raise AssertionError(f"rank {r['rank']}: dequantize must launch once (the restore) and "
                                 f"target_assign once (the step): {r['launches']}")
    launches = {k: sum(r["launches"].get(k, 0) for r in ranks) for k in ("dequantize", "target_assign")}
    nccl = "not run: 1 card"
    if torch.cuda.device_count() >= 2:
        # the same mesh on NCCL, one card per rank: the engine's and the step's graphs, collectives inside
        nccl_ranks = join_dp_ranks("spatial_nccl", start_ranks(["--spatial-nccl-rank"], work, "spatial_nccl", []),
                                   SPATIAL_TIMEOUT_S)
        lead, follower = nccl_ranks
        if [r["device"] for r in nccl_ranks] != ["cuda:0", "cuda:1"] or follower.get("engine_served") != len(
                zero["frame_ms"]) or lead["digest"] != follower["digest"] or lead["losses"] != follower["losses"]:
            raise AssertionError(f"the NCCL ranks: devices {[r['device'] for r in nccl_ranks]}, follower served "
                                 f"{follower.get('engine_served')}, digests or losses differing")
        vs_gloo = {"rotation": 0.0, "translation_mm": 0.0}
        for i, (p, q) in enumerate(zip(lead["engine_poses"], zero["engine_poses"])):
            bound = hold.bounds(read_golden()[0], i, False)  # rotation and translation: no hand bound read
            rot = float(np.abs(np.subtract(p[0], q[0])).max())
            mm = float(np.abs(np.subtract(p[1], q[1])).max()) * 1e3
            if rot > bound["rotation"] or mm > bound["translation"]:
                raise AssertionError(f"frame {i}: the graphed NCCL engine's pose is {rot} rad, {mm} mm off the "
                                     f"gloo ranks' eager one (bounds {bound})")
            vs_gloo = {"rotation": max(vs_gloo["rotation"], rot), "translation_mm": max(vs_gloo["translation_mm"], mm)}
        nccl = {"ranks": 2, "cards": 2, "engine_graphed": True, "engine_worst": lead["engine_worst"],
                "engine_vs_gloo_eager_worst": vs_gloo,
                "engine_vs_gloo_eager_bit_equal": lead["engine_poses"] == zero["engine_poses"],
                "engine_ms_per_frame": lead["engine_ms_per_frame"], "step_bit_equal": True,
                "collectives_per_replay": lead["collectives_per_replay"], "seconds": [r["seconds"] for r in nccl_ranks]}
        for k in launches:
            launches[k] += sum(r["launches"].get(k, 0) for r in nccl_ranks)
    return {
        "ranks": 2, "layout": {"data": 1, "model": 1, "space": 2}, "backend": "gloo", "shared_card": True,
        "frames": len(zero["frame_ms"]), "frame_ms_p50": [r["frame_ms_p50"] for r in ranks],
        "frame_ms": zero["frame_ms"], "worst": zero["worst"], "tie_switches": zero["tie_switches"],
        "fp32_max_abs_gap": zero["fp32_max_abs_gap"], "engine_ms_per_frame": zero["engine_ms_per_frame"],
        "engine_vs_single_worst": zero["engine_vs_single_worst"], "engine_batch_sizes": zero["engine_batch_sizes"],
        "step_ms": [r["step_ms"] for r in ranks], "step_max_rel_loss_gap": zero["step_max_rel_loss_gap"],
        "step_grad_gap_of_bound": [r["step_grad_gap_of_bound"] for r in ranks],
        "step_grad_norm": zero["step_grad_norm"],
        "step_max_param_gap": zero["step_max_param_gap"], "losses": zero["losses"],
        "collectives_per_forward": zero["collectives_per_forward"],
        "collective_ms_per_forward": zero["collective_ms_per_forward"],
        "collectives": zero["collectives"], "startup_s": [r["startup_s"] for r in ranks],
        "waited_s": [r["waited_s"] for r in ranks], "phase_s": [r["phase_s"] for r in ranks],
        "wall_s": time.perf_counter() - t0, "nccl": nccl, "launches": launches, "card": card,
    }


def phase_train_multi(card: str, work: str, generation: subprocess.Popen) -> dict:
    """Two objects a frame, object 2 symmetric: the 400-frame two-object set,
    the artifact widened to two classes, four reference steps through the
    step's graph, the graph against the eager step, then an epoch through cli
    train's trainer (its graph) with validation once per class."""
    import torch

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.models.weights import widen_classes
    from hmd_ego_pose_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES, ResidentGraph
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
    if not (ref_trainer.graphed and ref_trainer.step_fn.symmetric):
        raise AssertionError("the two-object set (object 2 symmetric) must train through the step's graph")
    graph = ref_trainer.graph
    LAUNCHES.reset()

    def graph_step(s):
        graph(fixed_batch(ref_trainer, s).cpu(), None, None)
        return dict(zip(METRIC_NAMES, graph.metrics[s]))

    ref_gaps = hold_to_reference(reference, graph_step, "graphed multi-object training")
    if LAUNCHES.get("target_assign") != len(reference["steps"]):
        raise AssertionError(f"the graph must launch target_assign once per step, got {LAUNCHES.snapshot()}")
    ref_pool_mb = graph_pool_mb(graph, ref_trainer.device)
    variant = variant_graph_against_eager(
        ref_trainer, ResidentGraph(ref_trainer.step_fn, ref_trainer.data, VARIANT_GRAPH_ROWS),
        index_rows(len(ref_trainer.train_dataset), ref_trainer.config.train.batch_size),
        lambda idx, draws, g: ref_trainer.step_fn(ref_trainer.data, idx.to(ref_trainer.device), draws, g))
    del ref_trainer, graph
    torch.cuda.empty_cache()

    ckpt_dir = os.path.join(work, "multi_ckpt")
    LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = cli.build_trainer(args, logger=logger, oversample=1, checkpoint_dir=ckpt_dir)
    if not trainer.graphed:
        raise AssertionError("cli train's two-object trainer on the card must replay its step's graph")
    run = fit_timed(trainer)
    launches = LAUNCHES.snapshot()
    epoch_pool_mb = graph_pool_mb(trainer.graph, trainer.device)
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
    forward = trainer.predict_fn
    last = getattr(forward, "host_images", None)  # the validation's last batch, replayed and eager
    eval_graph = eval_graph_against_eager(forward, [] if last is None else [
        (last.numpy().copy(), forward.host_cameras.numpy().copy())])
    _, result = run["epochs"][-1]
    return {
        "reference_max_rel_gap": ref_gaps, "reference_tolerance_rel": reference["tolerance_rel"],
        "reference_graph_pool_mb": ref_pool_mb, "graph_against_eager": variant, "graphed": True,
        "epoch_graph_pool_mb": epoch_pool_mb, "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "gt_0_yml_sha256": gt_hash, **generated, **timed.summary(batch),
        "frames": len(trainer.train_dataset), "val_frames": len(trainer.val_dataset), "fit_s": run["fit_s"],
        "validate_s": run["val_s"][0] if run["val_s"] else None, "eval_graph": eval_graph,
        "val_per_class": {c: {k: r.scalars()[k] for k in ("num_matched", "mean_ap", "mixed_point_distance_mean_mm")}
                          for c, r in sorted(result.per_class.items())},
        "launches": launches, **saved, "card": card,
    }


class FirstFrame:
    """A dataset's first frame as a dataset of one (its per-frame bytes)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return 1

    def __getattr__(self, name):
        return getattr(self.dataset, name)


def phase_train_windowed(card: str, data: str, work: str, resident_peak_gb: float) -> dict:
    """The 600 train frames with a budget of a third of them (200 frames): three
    windows through one buffer and one step graph, then the graph against the
    eager step."""
    import torch

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
    from hmd_ego_pose_tpu_torch.data.device_dataset import build_host_cache
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.train import trainer as trainer_module
    from hmd_ego_pose_tpu_torch.train.step import ResidentGraph
    from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

    split = ColibriDataset(data, 0, 1, "train")
    per_frame, window = build_host_cache(FirstFrame(split), 1).bytes_per_frame(), len(split) // 3
    args = cli.build_parser().parse_args(["train", "--dataset-path", data, "--ckpt", ARTIFACT, "--epo", "1"])
    LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = cli.build_trainer(args, logger=MetricLogger(os.path.join(work, "runs"), stdout=False),
                                    data_overrides={"device_resident_budget_bytes": window * per_frame + 1024},
                                    oversample=1, checkpoint_dir=os.path.join(work, "windowed_ckpt"))
    if trainer.path != "windowed" or trainer.window_frames != window or not trainer.graphed:
        raise AssertionError(f"expected graphed windows of {window} frames, got the {trainer.path} path "
                             f"({trainer.window_frames} frames, graphed {trainer.graphed})")
    # the window buffer is allocated with the trainer: each window fills it in place
    buffer_bytes = sum(t.numel() * t.element_size() for t in trainer.window.data)
    base, address = torch.cuda.memory_allocated(), trainer.window.data.frames.data_ptr()
    resident, fill = [], trainer.window.fill

    def one_window(cache, rows):
        out = fill(cache, rows)
        torch.cuda.synchronize()
        if out.frames.data_ptr() != address:
            raise AssertionError("a window was uploaded somewhere else than the window buffer")
        resident.append(torch.cuda.memory_allocated() - base)
        return out

    trainer.window.fill = one_window
    timed = trainer.graph = TimedGraph(trainer.graph)
    plan = trainer_module.window_plan
    per_window = VARIANT_STEPS // 3

    def short_plan(*a, **kw):  # each window's index rows cut to its first per_window steps
        return [(rows, idxs[:per_window]) for rows, idxs in plan(*a, **kw)]

    trainer_module.window_plan = short_plan
    try:
        t0 = time.perf_counter()
        metrics = trainer.train_epoch(0)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
    finally:
        trainer_module.window_plan = plan
    launches = LAUNCHES.snapshot()
    batch, steps = trainer.config.train.batch_size, len(timed.step_ms)
    window_bytes = window * per_frame
    if trainer.windows != [window] * 3 or not steps == metrics["steps"] == 3 * per_window:
        raise AssertionError(f"windows {trainer.windows}, {steps} steps, epoch says {metrics['steps']}")
    timed.check_finite()
    if launches.get("target_assign", 0) != steps:
        raise AssertionError(f"target_assign must launch once per step ({steps}), got {launches}")
    # one window resident: the buffer holds one window, and after the first
    # window's steps (Adam's moments, the graph's memory) nothing grows but the
    # windows' means (bytes)
    pool_mb = graph_pool_mb(timed, trainer.device)
    adam_bytes = 2 * sum(p.numel() * p.element_size() for p in trainer.optimizer.params)
    if (buffer_bytes > window_bytes + 1024 or max(resident[1:]) - min(resident[1:]) > (1 << 20)
            or max(resident) > adam_bytes + pool_mb * 1e6 + (1 << 20)):
        raise AssertionError(f"more than one window resident: a buffer of {buffer_bytes} bytes for a window of "
                             f"{window_bytes}, {resident} bytes over the model and buffer after each fill "
                             f"(Adam's moments {adam_bytes}, the graph's pool {pool_mb} MB)")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    variant = variant_graph_against_eager(
        trainer, ResidentGraph(trainer.step_fn, trainer.window.data, VARIANT_GRAPH_ROWS),
        index_rows(trainer.windows[-1], batch),
        lambda idx, draws, g: trainer.step_fn(trainer.data, idx.to(trainer.device), draws, g))
    return {
        **timed.summary(batch), "windows": trainer.windows, "window_mb": window_bytes / 1e6,
        "buffer_mb": buffer_bytes / 1e6, "split_mb": per_frame * len(trainer.train_dataset) / 1e6,
        "epoch_s": epoch_s, "held_mb_after_each_fill": [r / 1e6 for r in resident],
        "adam_moments_mb": adam_bytes / 1e6, "epoch_graph_pool_mb": pool_mb, "graph_against_eager": variant,
        "peak_mem_gb": peak_gb, "resident_run_peak_mem_gb": resident_peak_gb, "launches": launches, "card": card,
    }


def phase_train_host(card: str, data: str, work: str, resident: dict) -> dict:
    """device_augment=False: the host input pipeline.  Four fixed steps
    (augmentation off) through the step's graph (``HostGraph``), held to the
    resident path's JAX reference, then an augmented epoch through the graph
    cut to ``VARIANT_STEPS`` batches (4 worker threads), the input's wait
    apart from the replays; then the graph against the eager step on batches
    made in this thread, for ``Batch`` and for ``RawBatch`` sources."""
    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.ops.augment_device import Batch, RawBatch
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES, HostGraph
    from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

    with open(TRAIN_REFERENCE) as f:
        reference = json.load(f)
    args = cli.build_parser().parse_args(["train", "--dataset-path", data, "--ckpt", ARTIFACT, "--epo", "1"])
    logger = MetricLogger(os.path.join(work, "runs"), stdout=False)
    off = {"device_augment": False, "use_6dof_augmentation": False, "use_colorspace_augmentation": False}
    with contextlib.redirect_stdout(io.StringIO()):
        ref_trainer = cli.build_trainer(args, logger=logger, data_overrides=off,
                                        checkpoint_dir=os.path.join(work, "host_ref_ckpt"))
        # raw batches preprocessed on the device (and, at the end, augmented in the graph)
        raw_trainer = cli.build_trainer(args, logger=logger, data_overrides={"device_resident": False},
                                        checkpoint_dir=os.path.join(work, "host_ckpt"))
    batch = ref_trainer.config.train.batch_size
    seeds = np.zeros(batch, np.int64)

    def host_batch(s):
        return ref_trainer.pipeline._make_batch(np.arange(batch * s, batch * (s + 1)), seeds)

    # the same batch from the host preprocess and from the device one
    host = ref_trainer.step_fn.prepare_host(host_batch(0))
    dev = raw_trainer.step_fn.prepare_host(raw_trainer.pipeline._make_raw_batch(np.arange(batch), seeds))
    batch_gap = {name: float((a.double() - b.double()).abs().max()) for name, a, b in zip(host._fields, host, dev)}
    del host, dev
    if not isinstance(ref_trainer.graph, HostGraph):
        raise AssertionError(f"the host pipeline's trainer on the card must hold a HostGraph, got {ref_trainer.graph}")
    graph = ref_trainer.graph
    LAUNCHES.reset()

    def graph_step(s):
        graph(host_batch(s), None, None)
        return dict(zip(METRIC_NAMES, graph.metrics[s]))

    gaps = hold_to_reference(reference, graph_step, "graphed host-pipeline training")
    if LAUNCHES.get("target_assign") != len(reference["steps"]):
        raise AssertionError(f"the graph must launch target_assign once per step, got {LAUNCHES.snapshot()}")
    del ref_trainer, graph
    torch.cuda.empty_cache()

    LAUNCHES.reset()
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = cli.build_trainer(args, logger=logger, data_overrides={"device_augment": False}, oversample=1,
                                    checkpoint_dir=os.path.join(work, "host_ckpt"))
    if not trainer.graphed:
        raise AssertionError("the host pipeline's trainer on the card must replay its step's graph")
    timed = trainer.graph = TimedGraph(trainer.graph)
    # the epoch cut to its first VARIANT_STEPS batches (the sampler's rows as
    # drawn), each wait for the pipeline's next batch timed apart from the replays
    epoch_indices, batches, waits = trainer.pipeline.epoch_indices, trainer.pipeline.batches, []
    trainer.pipeline.epoch_indices = lambda oversample=1: epoch_indices(oversample)[:VARIANT_STEPS]

    def waited(*a, **kw):
        made = batches(*a, **kw)
        try:
            while True:
                t = time.perf_counter()
                try:
                    out = next(made)
                except StopIteration:
                    return
                waits.append((time.perf_counter() - t) * 1e3)
                yield out
        finally:
            made.close()

    trainer.pipeline.batches = waited
    t0 = time.perf_counter()
    metrics = trainer.train_epoch(0)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    trainer.pipeline.epoch_indices, trainer.pipeline.batches = epoch_indices, batches
    launches = LAUNCHES.snapshot()
    steps = len(timed.step_ms)
    if trainer.path != "host" or not steps == metrics["steps"] == VARIANT_STEPS:
        raise AssertionError(f"{steps} host steps on the {trainer.path} path, epoch says {metrics['steps']}")
    timed.check_finite()
    if launches.get("target_assign", 0) != steps:
        raise AssertionError(f"target_assign must launch once per step ({steps}), got {launches}")
    pool_mb = graph_pool_mb(timed, trainer.device)

    # the graph against the eager step on augmented batches made in this thread
    # (the host's time to make one), host-preprocessed and raw
    serial = trainer.pipeline.batches(oversample=1, num_workers=1)
    make_ms, made = [], []
    for _ in range(VARIANT_AB_STEPS):
        t = time.perf_counter()
        made.append(next(serial))
        make_ms.append((time.perf_counter() - t) * 1e3)
    serial.close()
    if not all(isinstance(b, Batch) for b in made):
        raise AssertionError("device_augment=False must give host-preprocessed batches")
    variant = variant_graph_against_eager(trainer, HostGraph(trainer.step_fn, VARIANT_GRAPH_ROWS), made,
                                          trainer.step_fn.host_step)
    del trainer, made
    torch.cuda.empty_cache()
    serial = raw_trainer.pipeline.batches(oversample=1, num_workers=1)
    raw = [next(serial) for _ in range(2)]
    serial.close()
    if raw_trainer.path != "host" or not all(isinstance(b, RawBatch) for b in raw):
        raise AssertionError(f"device_resident=False must feed raw batches to the host path, got {raw_trainer.path}")
    raw_variant = variant_graph_against_eager(raw_trainer, HostGraph(raw_trainer.step_fn, len(raw)), raw,
                                              raw_trainer.step_fn.host_step, turns=0, profile=False)
    return {
        "reference_max_rel_gap": gaps, "reference_tolerance_rel": reference["tolerance_rel"],
        "host_vs_device_batch_max_abs": batch_gap, **timed.summary(batch), "epoch_s": epoch_s,
        "input_wait_ms": waits, "input_wait_ms_p50": float(np.median(waits)),
        "replay_ms_p50": float(np.median(timed.step_ms[1:])), "make_batch_ms_p50": float(np.median(make_ms)),
        "workers": raw_trainer.config.data.num_workers, "epoch_graph_pool_mb": pool_mb,
        "graph_against_eager": variant, "raw_graph_against_eager": raw_variant,
        "resident_step_ms_p50": resident["step_ms_p50"], "resident_images_per_s": resident["images_per_s"],
        "launches": launches, "card": card,
    }


def phase_train_remat(card: str, data: str, work: str) -> dict:
    """remat_backbone with the backbone trainable: the same state, batch and
    drop-connect seed through one eager remat and one eager plain step (their
    losses equal, the BN statistics moved once); then each one's graph
    against its eager step, with the graphs' times in turns, peaks and
    pools; then ``--fine-tune`` (Nesterov SGD) through its graph the same way."""
    import numpy as np
    import torch

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
    from hmd_ego_pose_tpu_torch.train.state import NesterovSGD
    from hmd_ego_pose_tpu_torch.train.step import ResidentGraph
    from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

    argv = ["train", "--dataset-path", data, "--ckpt", ARTIFACT, "--epo", "1"]
    off = {"use_6dof_augmentation": False, "use_colorspace_augmentation": False}
    runs, states, lr, steps = {}, {}, None, 0
    LAUNCHES.reset()

    def build(extra, remat):
        with contextlib.redirect_stdout(io.StringIO()):
            trainer = cli.build_trainer(cli.build_parser().parse_args(argv + extra),
                                        logger=MetricLogger(os.path.join(work, "runs"), stdout=False),
                                        data_overrides=off, model_overrides={"remat_backbone": remat},
                                        checkpoint_dir=os.path.join(work, "remat_ckpt"))
        if not trainer.graphed:
            raise AssertionError(f"the trainer of {extra}, remat {remat} on the card must replay its step's graph")
        batch = trainer.config.train.batch_size
        sources = [torch.arange(batch * s, batch * (s + 1)) for s in range(VARIANT_AB_STEPS)]

        def eager(idx, draws, generator):
            return trainer.step_fn(trainer.data, idx.to(trainer.device), draws, generator)

        return trainer, sources, eager

    for remat in (True, False):
        trainer, sources, eager = build(["--no-freeze-backbone"], remat)
        lr = trainer.config.train.learning_rate
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer.generator.manual_seed(5)
        t0 = time.perf_counter()
        m = eager(sources[0], None, trainer.generator)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        first = {k: float(v) for k, v in m.items()}
        states[remat] = ({k: v.clone() for k, v in trainer.model.state_dict().items()}, first)
        eager_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        restore_state(trainer, before)
        # the plain step is the baseline: two steps, its times, no profile
        n = len(sources) if remat else 2
        variant = variant_graph_against_eager(
            trainer, ResidentGraph(trainer.step_fn, trainer.data, n + VARIANT_TURNS + int(remat)), sources[:n], eager,
            profile=remat)
        steps += 1 + variant["steps"]
        runs["remat" if remat else "plain"] = {"eager_step_ms_first": first_ms, "eager_peak_mem_gb_first_step": eager_peak,
                                               "losses_first": first, "graph_against_eager": variant}
        del trainer, eager
        torch.cuda.empty_cache()
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
    backbone_moved = any(not torch.equal(p_state[k], before[k]) for k in params if k.startswith("backbone_net."))
    if not backbone_moved:
        raise AssertionError("the backbone did not train (--no-freeze-backbone)")

    # fine_tune: Nesterov SGD over a device learning rate, through its graph
    trainer, sources, eager = build(["--fine-tune"], False)
    if not isinstance(trainer.optimizer.opt, NesterovSGD):
        raise AssertionError(f"--fine-tune must train with NesterovSGD, got {trainer.optimizer.opt!r}")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items() if not k.startswith("backbone_net.")}
    sgd = variant_graph_against_eager(trainer, ResidentGraph(trainer.step_fn, trainer.data, 2 + VARIANT_TURNS),
                                      sources[:2], eager, profile=False)
    steps += sgd["steps"]
    after = trainer.model.state_dict()
    sgd["head_tensors_moved"] = sum(not torch.equal(after[k], v) for k, v in before.items())
    if not sgd["head_tensors_moved"] or not all(torch.isfinite(after[k]).all() for k in before):
        raise AssertionError(f"SGD's steps left the parameters unmoved or non-finite: {sgd['head_tensors_moved']} moved")
    del trainer, eager
    torch.cuda.empty_cache()
    launches = LAUNCHES.snapshot()
    if launches.get("target_assign", 0) != steps:
        raise AssertionError(f"target_assign must launch once per step ({steps}), got {launches}")
    graph_ms = {k: float(np.median(r["graph_against_eager"]["turns_step_ms"]["graph"])) for k, r in runs.items()}
    return {
        **runs, "losses_equal": True, "bn_stats_moved": len(moved), "bn_stat_max_rel_gap": stat_gap,
        "param_max_abs_gap": param_gap,
        "params_differing": sum(int((r_state[k] != p_state[k]).sum()) for k in params),
        "remat_over_plain_graph_step": graph_ms["remat"] / graph_ms["plain"], "sgd": sgd,
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

    def top10(rows, key):
        return [{"name": e.key[:96], "ms_per_request": key(e) / 1e3 / n, "calls_per_request": e.count / n}
                for e in sorted(rows, key=key, reverse=True)[:10] if key(e) > 0]

    return {
        "requests": n, "host_ms": host_ms, "device_ms": device_ms or None,
        "device_busy_share": device_ms / host_ms if device_ms else None,
        "ops_device_ms": sum(device_us(e) for e in ops) / 1e3 / n,
        "kernels_per_request": sum(e.count for e in kernels) / n, **launch_calls(events, n, "request"),
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
    Then one I420 request under the profiler."""
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
        profile = profile_requests(client, payloads["i420"][:1], protocol.KIND_I420, size)
    return {
        "frames_per_kind": len(frames), "byte_equal_to_rgb8_of_decoded": 2 * len(frames),
        "conversions": conversions,
        **{f"rtt_ms_{name}_p50": float(np.percentile(v, 50)) for name, v in rtts.items()},
        **{f"rtt_ms_{name}_max": max(v) for name, v in rtts.items()},
        "profile": profile,
    }


SERVE_TURNS = 4  # round trips of each path, graph against eager, in turns, cut to keep the script's time


def engine_graphs(engine, frames) -> dict:
    """The engine's CUDA graphs, one per batch size: each size's replay of the
    golden frames (repeated to fill it) against the eager ``_predict`` of the
    same frames, bit for bit; two batches of one size in flight at once,
    each resolving to its own eager answer; the capture's seconds and the
    graphs' pool."""
    import numpy as np
    import torch

    def host(det):
        torch.cuda.synchronize()
        return [t.cpu() for t in det]

    def eager(f, c):
        return host(engine._predict(torch.from_numpy(f).to(engine.device), torch.from_numpy(c).to(engine.device)))

    def cameras(b):
        return np.tile(engine._default_camera()[None], (b, 1))

    if sorted(engine.graphs) != engine.batch_sizes:
        raise AssertionError(f"graphs for {sorted(engine.graphs)}, batch sizes {engine.batch_sizes}")
    for b in engine.batch_sizes:
        f = frames[np.arange(b) % len(frames)]
        if not all(torch.equal(g, w) for g, w in zip(host(engine._dispatch_device(f, cameras(b))), eager(f, cameras(b)))):
            raise AssertionError(f"batch size {b}: the graph's replay differs from the eager predict")
    n = max(b for b in engine.batch_sizes if b <= 2)  # two batches of 2 frames (of 1 on an engine of batch 1)
    a, b = frames[:n], frames[4:4 + n]
    first = engine._dispatch_device(a, cameras(n))
    second = engine._dispatch_device(b, cameras(n))  # the same graph replays before the first batch is read
    for got, f in ((first, a), (second, b)):
        if not all(torch.equal(g, w) for g, w in zip(host(got), eager(f, cameras(n)))):
            raise AssertionError("a batch in flight did not keep its own answer")
    return {"batch_sizes": engine.batch_sizes, "replays_bit_equal_to_eager": len(engine.batch_sizes),
            "in_flight_own_answers": 2, "capture_s": engine.capture_s, "graph_pool_bytes": engine.graph_pool_bytes}


def rtt_turns(client, engine, frames) -> dict:
    """Round trips of batch-1 RGB8 requests, graph against eager in turns
    (graph, eager, eager, graph, ...; the eager turns run with the engine's
    graphs set aside), then one profiled request of each."""
    import numpy as np

    from hmd_ego_pose_tpu_torch.serving import protocol

    held, rtts, profiles = engine.graphs, {"graph": [], "eager": []}, {}
    order = [("graph", "eager"), ("eager", "graph")] * (SERVE_TURNS // 2)
    try:
        for i, path in enumerate(p for pair in order for p in pair):
            engine.graphs = held if path == "graph" else {}
            t = time.perf_counter()
            if client.infer(frames[i % len(frames)]) is None:
                raise AssertionError(f"{path} turn {i}: no detection served")
            rtts[path].append((time.perf_counter() - t) * 1e3)
        for path in ("graph", "eager"):
            engine.graphs = held if path == "graph" else {}
            profiles[path] = profile_requests(client, [frames[0].tobytes()], protocol.KIND_RGB8, frames.shape[1:3])
    finally:
        engine.graphs = held
    return {
        "rtt_ms": rtts, "rtt_ms_p50": {k: float(np.median(v)) for k, v in rtts.items()},
        "rtt_ms_max": {k: max(v) for k, v in rtts.items()},
        "profile_one_request": {k: {n: p[n] for n in ("host_ms", "device_ms", "kernels_per_request",
                                                       "launch_calls_per_request", "graph_launches_per_request",
                                                       "aten_calls_per_request")}
                                for k, p in profiles.items()},
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
            if engine.eager_batches:
                raise AssertionError(f"{engine.eager_batches} batches of a captured size ran eagerly")
            graphs = engine_graphs(engine, frames)
            turns = rtt_turns(client, engine, frames)
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
        if engine.eager_batches:
            raise AssertionError(f"{engine.eager_batches} batches of a captured size ran eagerly")
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
        "endpoint": endpoint, **yuv, "graphs": graphs, "graph_against_eager": turns,
        "eager_batches": engine.eager_batches,
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


EVAL_TURN_BATCHES = 6  # evaluation batches replayed and eager in turns (of 25), cut to keep the script's time


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
    with contextlib.redirect_stdout(report), recording_eval_forwards() as made:
        result = cli.main(["evaluate", "--dataset-path", data, "--ckpt", ARTIFACT, "--partition", "val"])
    t_evaluate = time.perf_counter() - t2
    launches = LAUNCHES.snapshot()
    print(report.getvalue().split("\n{")[0], flush=True)  # the 17-line report
    if len(made) != 1:
        raise AssertionError(f"cli evaluate made {len(made)} predict callables, not one")
    # the evaluation's first batches again, replayed and eager in turns, bit for bit
    eval_graph = eval_graph_against_eager(made[0].forward, made[0].calls[:EVAL_TURN_BATCHES])

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
        "frames": frames, **generated, "read_s": t_read, "evaluate_s": t_evaluate, "eval_graph": eval_graph,
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
    with contextlib.redirect_stdout(quiet), recording_eval_forwards() as made:
        result = cli.main(["evaluate", "--dataset-path", data, "--ckpt", ckpt, "--partition", "val", "--iter", "1",
                           "--save-images-path", images])
    seconds["evaluate"] = time.perf_counter() - t
    if len(made) != 1:
        raise AssertionError(f"cli evaluate --iter 1 made {len(made)} predict callables, not one")
    eval_graph = eval_graph_against_eager(made[0].forward, made[0].calls[:2])
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
        "seconds": seconds, "iter1_npz_digest": digest, "scalars": got, "worst_gap": worst, "eval_graph": eval_graph,
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
    if sys.argv[1:2] == ["--mesh-graph-rank"]:  # the mesh_graph phase's one NCCL rank
        work, data, go, space_go = sys.argv[2:6]
        print(json.dumps(mesh_graph_rank(data, work, go, space_go)), flush=True)
        faulthandler.cancel_dump_traceback_later()
        return 0
    if sys.argv[1:2] == ["--spatial-nccl-rank"]:  # one rank of the spatial phase's NCCL block (two cards)
        print(json.dumps(spatial_nccl_rank(sys.argv[2])), flush=True)
        faulthandler.cancel_dump_traceback_later()
        return 0
    if sys.argv[1:2] == ["--spatial-rank"]:  # one rank of the spatial phase
        print(json.dumps(spatial_rank(*sys.argv[2:4])), flush=True)
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
    # train_dp's and spatial's ranks start up (import, restore, data upload) while the train phase runs
    go, spatial_go, mesh_go, space_go = (os.path.join(work, name)
                                         for name in ("dp_go", "spatial_go", "mesh_go", "space_go"))
    children.update(zip(("dp0", "dp1"), start_dp_ranks("gloo", data, os.path.join(work, "dp"), go)))
    children.update(zip(("sp0", "sp1"), start_spatial_ranks(os.path.join(work, "spatial"), spatial_go)))
    (children["mesh"],) = start_ranks(["--mesh-graph-rank"], os.path.join(work, "mesh"), "mesh_graph",
                                      [data, mesh_go, space_go], world=1)
    train = phase_train(card, data, work)
    emit("train", **train)
    dp = phase_train_dp(card, data, work, train, [children["dp0"], children["dp1"]], go)
    emit("train_dp", **dp)
    mesh_data_s = start_mesh_graph(children["mesh"], mesh_go)  # the data probe, alone on the card
    spatial = phase_spatial(card, [children["sp0"], children["sp1"]], spatial_go, os.path.join(work, "spatial"))
    emit("spatial", **spatial)
    multi = phase_train_multi(card, work, children["multi"])
    emit("train_multi", **multi)
    windowed = phase_train_windowed(card, data, work, train["peak_mem_gb"])
    emit("train_windowed", **windowed)
    host = phase_train_host(card, data, work, train)
    emit("train_host", **host)
    remat = phase_train_remat(card, data, work)
    emit("train_remat", **remat)
    # the space probe runs beside the export phase, whose work is the host's (torch.export, saves)
    with open(space_go, "w"):
        pass
    export = phase_export(card, work)
    emit("export", **export)
    mesh_graph = phase_mesh_graph(card, children["mesh"], dp, mesh_data_s)
    emit("mesh_graph", **mesh_graph)
    rest = phase_cli_rest(card, data, work)
    emit("cli_rest", **rest)

    leftover = [t.name for t in threading.enumerate()
                if t is not threading.main_thread() and t.is_alive() and not t.daemon]
    if leftover:
        raise RuntimeError(f"threads still alive after shutdown: {leftover}")
    emit("shutdown", threads_alive=[t.name for t in threading.enumerate() if t.is_alive()],
         total_s=time.perf_counter() - t_all, process_s=process_seconds())

    # every count is read from a main path's run: target_assign summed over the
    # training runs (the data-parallel one's over its two ranks, the probe
    # meshes' steps, the spatial ranks' and cli_rest's iter-1 steps), min_distances over the evaluation, the two-class
    # validation and the iter-1 evaluation, dequantize over serve and cli_rest,
    # quantize over export and cli_rest's int8 save
    trainings = (train, multi, windowed, host, remat, dp, rest, spatial, mesh_graph)
    launches = {"dequantize": sum(p["launches"].get("dequantize", 0) for p in (serve, rest, spatial)),
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
