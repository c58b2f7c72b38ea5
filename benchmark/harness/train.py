"""Training cells: ``Trainer.train_epoch`` on the resident, graphed path.

Set-up makes the split from the seed (``harness/synthetic.py``, under the
run's ``TMPDIR``), draws the weights of the configuration's widths on the
card from the seed (``reference/shapes.py``: one normal draw), and builds
the program's ``Trainer`` with ``cli train``'s defaults (batch 16, Adam
1e-4, frozen backbone, augmentation and drop-connect on the device,
oversample 10).  Its
first epoch is the warm-up: the first step captures the step's CUDA graph,
and the first ``CHECKED_STEPS`` steps are recorded for the reference (their
indices, augmentation draws, the generator's state for the drop-connect
uniforms, the parameters after them).  Then the window: whole epochs,
each ending in the host's read of its losses, until ``seconds`` have
passed; the rate is the images of those epochs over their seconds.

A traced run profiles one whole epoch in the window's middle.  Every run
records a CUDA event as each step of the window is enqueued: the device's
time from one step to the next, at an epoch's edge against inside it, is
what the edge costs (``epoch_edge``), which the 40-frame split weighs far
more than a deployment's split does (PERF.md).

``correct``: the reference (``reference/train_check.py``) follows the
checked steps from the same weights and raw frames once the window has
closed; losses, first gradients and changes within their limits.
"""

from __future__ import annotations

import gc
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np

from harness import common

CHECKED_STEPS = 3


def nest(flat: Dict[str, object]) -> Dict:
    """'a/b/0/c' paths -> nested dicts, a dict of consecutive integer keys a list."""
    root: Dict = {}
    for path, value in flat.items():
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys) and sorted(int(k) for k in keys) == list(range(len(keys))):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def read_ply_points(path: str) -> np.ndarray:
    with open(path) as f:
        lines = f.read().splitlines()
    start = lines.index("end_header") + 1
    return np.array([[float(v) for v in line.split()[:3]] for line in lines[start:] if line.strip()], np.float32)


def draws_on(d, device) -> Dict:
    """A step's augmentation draws (the program's ``AugmentDraws``) as the
    reference reads them, on ``device``."""
    return {"apply": d.apply, "n_slots": d.n_slots, "op_ids": d.op_ids, "magnitudes": d.magnitudes.to(device),
            "factors": d.factors.to(device), "cutout_yx": d.cutout_yx.to(device),
            "noise": {s: v.to(device) for s, v in d.noise.items()}, "angles": d.angles.to(device),
            "scales": d.scales.to(device)}


class _Recorder:
    """Stands in for the step the trainer calls (its graph, or the eager
    step where there is none): keeps the first steps' inputs, losses and the
    state after them, and passes every call on.  A test's fault is planted
    in the same place."""

    def __init__(self, trainer, steps: int, fault: Optional[str] = None):
        self.trainer, self.steps = trainer, steps
        self.records: List[Dict] = []
        self.eager_losses: List[List[float]] = []
        self.grad: Optional[Dict[str, float]] = None
        self.change: Optional[Dict[str, float]] = None
        opt = trainer.optimizer
        self.names = ["/".join(str(p) for p in path) for _, path, _ in opt.entries]
        self.before = [p.detach().clone() for p in opt.params]
        self.graphed = trainer.graph is not None
        self.events: Optional[List] = None  # a CUDA event as each step is enqueued, once set to a list
        self.inner = trainer.graph if self.graphed else trainer.step_fn
        if fault == "half":  # the loss of the batch's first half alone
            step, losses = trainer.step_fn, trainer.step_fn.losses

            def half(batch, generator=None, drop=None):
                b = batch.images.shape[0] // 2
                return losses(type(batch)(*(f[:b] for f in batch)), generator, drop)

            step.losses = half
        elif fault == "unchanged":  # the update left out
            opt.opt.step = lambda *a, **k: None
        if self.graphed:
            trainer.graph = self
        else:
            trainer.step_fn = self

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, *args):
        import torch

        from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES

        source, draws, generator = args[-3:]
        if self.events is not None:
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[-1].record()
        if len(self.records) < self.steps:
            self.records.append({"idx": np.asarray(source.cpu()).copy(), "draws": draws,
                                 "generator_state": generator.get_state()})
        out = self.inner(*args)
        if self.change is None:  # one of the checked steps
            if self.trainer.device.type == "cuda":
                torch.cuda.synchronize()
            opt, n = self.trainer.optimizer, len(self.records)
            if not self.graphed:
                self.eager_losses.append([float(out[k]) for k in METRIC_NAMES])
            if n == 1:  # Adam's first moment after one step is (1 - 0.9) g
                self.grad = {name: float(opt._state(p, "exp_avg").norm()) / (1.0 - 0.9)
                             for name, p in zip(self.names, opt.params)}
            if n == self.steps:
                self.change = {name: float((p.detach() - b).norm())
                               for name, p, b in zip(self.names, opt.params, self.before)}
                self.before = None
        return out


def epoch_edge(events: Optional[List], steps: int, epoch_s: float) -> Optional[Dict[str, float]]:
    """From the window's step events (``steps`` to an epoch): the device's
    median time from a step to the next inside an epoch, the median from an
    epoch's last step to the next epoch's first, and what that edge costs
    an epoch, as a share of the epoch's seconds."""
    if not events or steps < 2 or len(events) < 2 * steps:
        return None
    events[-1].synchronize()
    gaps = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
    edges = gaps[steps - 1::steps]
    inner = [g for i, g in enumerate(gaps) if i % steps != steps - 1]
    step_ms, edge_ms = float(np.median(inner)), float(np.median(edges))
    return {"step_ms": step_ms, "edge_ms": edge_ms, "share_pct": (edge_ms - step_ms) / 1000.0 / epoch_s * 100.0}


def run(cell: Dict, seed: int, seconds: int, trace: bool, device=None, fault: Optional[str] = None) -> Dict:
    import torch

    device = torch.device(device or "cuda")
    root = common.work_dir("train")
    try:
        return _run(cell["config"], cell["traffic"], root, seed, seconds, trace, device, fault)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(conf: Dict, traffic: Dict, root: str, seed: int, seconds: int, trace: bool, device,
         fault: Optional[str]) -> Dict:
    import torch

    from harness import synthetic
    from harness import trace as tracing
    from reference import shapes, train_check
    from reference.model import Widths
    from hmd_ego_pose_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES
    from hmd_ego_pose_tpu_torch.train.trainer import Trainer

    tc_conf = conf["training"]
    size, widths = conf["image_size"], Widths.of(conf)
    data = synthetic.generate_dataset(root, conf["train_split_frames"], size, seed)
    data["points"] = read_ply_points(os.path.join(root, "models", "obj_01.ply"))

    gen = torch.Generator(device=device).manual_seed(seed)
    params, stats = shapes.draw(gen, device, widths)
    keep_params = {k: v.clone() for k, v in params.items()}
    bn_tree = nest({k: v for k, v in stats.items()})
    cfg = Config(
        model=ModelConfig(phi=conf["phi"], image_size=size, hand_relative=tc_conf["hand_relative"]),
        train=TrainConfig(batch_size=tc_conf["batch_size"], learning_rate=tc_conf["learning_rate"],
                          freeze_backbone=tc_conf["freeze_backbone"], oversample=tc_conf["oversample"],
                          seed=seed % (2 ** 32), checkpoint_dir=os.path.join(root, "weights")),
        data=DataConfig(dataset_path=root, image_size=size, device_augment=tc_conf["device_augment"]),
    )
    train_ds = ColibriDataset(root, 0, 1, "train")
    val_ds = ColibriDataset(root, 0, 1, "val")
    trainer = Trainer(cfg, train_ds, val_ds, device=device, params=nest(params), bn_state=bn_tree)
    del params
    if fault is None and trainer.path != "resident":
        raise RuntimeError(f"the trainer took the {trainer.path} path, not the resident one")
    recorder = _Recorder(trainer, CHECKED_STEPS, fault)
    trainer.train_epoch(0)  # warm-up: the capture and the checked steps
    checked_losses = (recorder.inner.metrics[:CHECKED_STEPS].tolist() if recorder.graphed
                      else recorder.eager_losses[:CHECKED_STEPS])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = common.process_age_s()

    epochs, images, prof, slice_steps, finite = 0, 0, None, None, True
    if device.type == "cuda":
        recorder.events = []
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        if trace and prof is None and time.monotonic() - t0 >= seconds / 3:
            with tracing.profiled() as box:
                out = trainer.train_epoch(1 + epochs)
            prof, slice_steps = box["trace"], out["steps"]
        else:
            out = trainer.train_epoch(1 + epochs)
        epochs += 1
        finite = finite and all(np.isfinite(out[k]) for k in METRIC_NAMES)
        images += out["steps"] * cfg.train.batch_size
    elapsed = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    edge = epoch_edge(recorder.events, images // cfg.train.batch_size // max(epochs, 1), elapsed / max(epochs, 1))

    prog = {"losses": checked_losses,
            "grad": recorder.grad, "change": recorder.change}
    steps = []
    for rec in recorder.records[:CHECKED_STEPS]:
        g = torch.Generator()
        g.set_state(rec["generator_state"])
        drop = torch.rand((len(widths.blocks()), cfg.train.batch_size), generator=g).to(device)
        steps.append({"idx": rec["idx"].tolist(), "draws": draws_on(rec["draws"], device), "drop": drop})
    del trainer, recorder
    gc.collect()  # the recorder and the trainer hold each other: free the step's graph and its pool now
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tdata = {k: torch.as_tensor(np.asarray(data[k]), device=device) for k in ("frames", "masks")}
    tdata.update({k: torch.as_tensor(np.asarray(data[k], np.float32), device=device) for k in
                  ("boxes", "rotvecs", "translations", "hands", "cameras", "points")})
    ref = train_check.follow(widths, keep_params, tdata, steps, size, lr=tc_conf["learning_rate"],
                             hand_relative=tc_conf["hand_relative"])
    gaps = train_check.compare(prog, ref)
    limits = common.load_json(os.path.join(common.BENCH, "reference", "limits", conf["name"] + ".json"))["train"]
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in sorted(limits)}
    correct = finite and all(gaps[k] <= limits[k] for k in limits)
    e2e = {"train_images_per_s": images / elapsed, "setup_s": setup_s}
    ctx = {"trace": prof, "slice_steps": slice_steps, "widths": widths, "image_size": size,
           "batch_size": cfg.train.batch_size, "window_images": images, "window_seconds": elapsed,
           "freeze_backbone": tc_conf["freeze_backbone"], "window_peak_bytes": peak}
    return {"e2e": e2e, "ctx": ctx, "correct": correct, "attempted": epochs, "failed": 0 if finite else 1,
            "peak": peak, "trace": prof, "checks": checks, "gaps": gaps,
            "replay": {"widths": widths, "params": keep_params, "data": tdata, "steps": steps, "size": size,
                       "lr": tc_conf["learning_rate"], "hand_relative": tc_conf["hand_relative"], "reference": ref},
            "extra": {"window": {"epochs": epochs, "images": images, "seconds": elapsed}, "epoch_edge": edge,
                      "readings": {"program": prog["losses"], "reference": ref["losses"]}}}
