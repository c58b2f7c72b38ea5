"""The port's training step against the JAX package's, at phi-0, 128 px, batch 2.

From the shipped artifact's fp32 params (``hand_relative`` as its sidecar
records), with augmentation and drop-connect off, on the frames the two
samplers pick from one seed:

* the first batch's six loss terms within 1e-5 relative, and the gradient
  of every trainable leaf against ``jax.value_and_grad`` of
  ``train/step.py::_compute_losses``: ``|g - g_jax| <= 1e-4 |g_jax| +
  1e-6 G`` in the leaf's 2-norm, G the global gradient norm.  Both are
  float32 with convolutions summed in other orders (the large leaves agree
  to ~1e-5); the absolute term covers the conv biases that feed a
  training-mode BN, whose gradient is zero up to rounding noise of ~1e-7 G;
* the running BN statistics after the step within 1e-5 relative (after two
  steps, plus momentum x the bias bound below);
* the parameters after two Adam steps of the port's trainer (built as
  ``cli train`` builds it) against the JAX package's two steps: every
  element within 2e-6, except those zero-gradient biases: Adam scales any
  gradient, noise included, to a step of about the learning rate, so their
  noise moves them by up to lr per step in either package and in either
  direction (bound 2 * steps * lr); the frozen backbone bit-identical.

The JAX side is computed once for the module.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmd_ego_pose_tpu.config import Config as JaxConfig
from hmd_ego_pose_tpu.config import DataConfig as JaxDataConfig
from hmd_ego_pose_tpu.config import ModelConfig as JaxModelConfig
from hmd_ego_pose_tpu.config import TrainConfig as JaxTrainConfig
from hmd_ego_pose_tpu.data.colibri import ColibriDataset as JaxColibriDataset
from hmd_ego_pose_tpu.data.device_dataset import build_host_cache, gather_raw_batch, upload_window
from hmd_ego_pose_tpu.data.pipeline import InputPipeline as JaxInputPipeline
from hmd_ego_pose_tpu.ops.augment_device import augment_and_preprocess_batch
from hmd_ego_pose_tpu.train import checkpoint as jax_checkpoint
from hmd_ego_pose_tpu.train.state import make_optimizer
from hmd_ego_pose_tpu.train.step import _compute_losses, effective_loss_config
from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.models.weights import to_jax_params
from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES, compute_losses

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "trained", "syn1000_phi0_576ep_handrel_int8.npz")
SIZE, BATCH, STEPS = 128, 2, 2
TERMS = ("total", "classification", "regression", "rotation", "translation", "hand")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def feeds_training_bn(key: str) -> bool:
    """A conv bias followed by a BN: in training mode the BN subtracts the batch
    mean, so its gradient is zero up to rounding noise (~1e-7 of the global norm)."""
    return key.endswith("conv.bias") and (
        ("pointwise_conv" in key and (key.startswith("bifpn.") or ".conv_list." in key))
        or "_down_channel" in key or "p5_to_p6" in key)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train") / "syn")
    cli.main(["make-synthetic", "--out-dir", root, "--num-frames", "8", "--frame-size", str(SIZE),
              "--hand-render-version", "3"])
    return root


@pytest.fixture(scope="module")
def jax_run(dataset):
    """Two JAX training steps: the first step's losses, gradients and BN state,
    and the params after both."""
    params, bn_state, meta = jax_checkpoint.restore_checkpoint(ARTIFACT)
    cfg = JaxConfig(model=JaxModelConfig(phi=0, image_size=SIZE, hand_relative=bool(meta["hand_relative"])),
                    train=JaxTrainConfig(batch_size=BATCH),
                    data=JaxDataConfig(dataset_path=dataset, use_6dof_augmentation=False,
                                       use_colorspace_augmentation=False, preload=False))
    ds = JaxColibriDataset(dataset, 0, 1, "train")
    data = upload_window(build_host_cache(ds, 1))
    idxs = JaxInputPipeline(ds, cfg.data, cfg.model, BATCH, seed=cfg.train.seed).epoch_indices(
        cfg.train.oversample)[:STEPS]
    model_points = ds.model_points_for_loss(cfg.train.loss.num_model_points)
    grad_fn = jax.jit(jax.value_and_grad(_compute_losses, has_aux=True), static_argnums=(5, 6, 7))
    tx = make_optimizer(cfg.train, params)
    opt_state = tx.init(params)
    first = None
    for s in range(STEPS):
        batch = augment_and_preprocess_batch(jax.random.PRNGKey(0), gather_raw_batch(data, jnp.asarray(idxs[s])),
                                             SIZE, use_colorspace=False, use_6dof=False)
        (_, (bundle, new_bn)), grads = grad_fn(params, bn_state, batch, None, model_points, cfg.model,
                                               effective_loss_config(cfg), cfg.train)
        if first is None:
            first = {"losses": [float(v) for v in (bundle.total, bundle.classification, bundle.regression,
                                                   bundle.rotation, bundle.translation, bundle.hand)],
                     "grads": jax.tree.map(np.asarray, grads), "bn": jax.tree.map(np.asarray, new_bn)}
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        bn_state = new_bn
    return {"idxs": idxs, **first, "params": jax.tree.map(np.asarray, params),
            "bn_after": jax.tree.map(np.asarray, bn_state)}


@pytest.fixture(scope="module")
def port_trainer(dataset, tmp_path_factory):
    args = cli.build_parser().parse_args(["train", "--dataset-path", dataset, "--ckpt", ARTIFACT,
                                          "--img-size", str(SIZE), "--batch-size", str(BATCH), "--device", "cpu"])
    return cli.build_trainer(args, checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")))


def test_same_epoch_indices(jax_run, port_trainer):
    np.testing.assert_array_equal(port_trainer.pipeline.epoch_indices(port_trainer.config.train.oversample)[:STEPS],
                                  jax_run["idxs"])


def test_first_step_losses_gradients_and_bn_match_jax(jax_run, port_trainer):
    t = port_trainer
    step = t.step_fn
    initial = {k: v.clone() for k, v in t.model.state_dict().items()}
    try:
        batch = step.prepare(t.data, torch.from_numpy(jax_run["idxs"][0]), None)
        bundle = compute_losses(t.model, batch, step.model_points, t.config, step.loss_cfg, step.anchors,
                                step.trans_anchors)
        bundle.total.backward()
        got = [float(v) for v in (bundle.total, bundle.classification, bundle.regression, bundle.rotation,
                                  bundle.translation, bundle.hand)]
        for term, g, w in zip(TERMS, got, jax_run["losses"]):
            assert g == pytest.approx(w, rel=1e-5), term
        grads = {k: p.grad for k, p in t.model.named_parameters() if p.grad is not None}
        diffs = {}
        for key, path, kind in step.optimizer.entries:
            g = grads[key].permute(2, 3, 1, 0) if kind == "conv" else grads[key]
            node = jax_run["grads"]
            for p in path:
                node = node[p]
            diffs[key] = (np.linalg.norm(g.numpy() - node), np.linalg.norm(node))
        assert len(grads) == len(step.optimizer.entries)  # the frozen backbone takes no gradient
        total = np.sqrt(sum(n ** 2 for _, n in diffs.values()))
        off = {k: d for k, (d, n) in diffs.items() if not d <= 1e-4 * n + 1e-6 * total}
        assert not off, off
        _, bn = to_jax_params(t.model.state_dict(), t.config.model)
        for g, w in zip(jax.tree.leaves(bn), jax.tree.leaves(jax_run["bn"])):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    finally:
        step.optimizer.zero_grad()
        t.model.load_state_dict(initial)


def test_two_trainer_steps_match_jax(jax_run, port_trainer):
    t = port_trainer
    backbone = {k: v.clone() for k, v in t.model.state_dict().items() if k.startswith("backbone_net.")
                and not k.endswith(("running_mean", "running_var"))}
    for s in range(STEPS):
        metrics = t.step_fn(t.data, torch.from_numpy(jax_run["idxs"][s]), None, None)
        assert set(metrics) == set(METRIC_NAMES)
    params, bn = to_jax_params(t.model.state_dict(), t.config.model)
    assert jax.tree.structure(params) == jax.tree.structure(jax_run["params"])
    adam_moves = 2 * STEPS * t.config.train.learning_rate
    for key, path, _ in t.optimizer.entries:
        got, want = params, jax_run["params"]
        for p in path:
            got, want = got[p], want[p]
        bound = adam_moves if feeds_training_bn(key) else 2e-6
        assert np.abs(got - want).max() <= bound, key
    # a running mean moves by momentum x the shift of those biases
    for g, w in zip(jax.tree.leaves(bn), jax.tree.leaves(jax_run["bn_after"])):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=t.config.model.bn_momentum * adam_moves)
    for k, v in backbone.items():
        assert torch.equal(t.model.state_dict()[k], v), k
    assert t.optimizer.count == STEPS
