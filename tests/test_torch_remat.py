"""``remat_backbone``: each MBConv block under ``torch.utils.checkpoint``, against the plain
forward and against the JAX package's remat step.

* On the CPU, a training forward and backward of the same weights, images and
  drop-connect generator, remat on and off (backbone trainable): the five
  head outputs, every gradient and every BN running statistic bit-identical,
  so the statistics moved once, as without remat (the recompute leaves them
  alone; ``nn/core.py::BatchNorm.update_stats``), while every block's
  forward ran twice (the recompute in the backward pass);
* the sigmoid's and swish's gradients against ``jax.nn.sigmoid``'s where
  exp(-x) overflows (x below about -88): finite, as the JAX package's (the
  port's formula differentiated op by op gave NaN there, which a trainable
  backbone reaches on the card);
* one Adam step of the port's trainer with remat and ``freeze_backbone=False``
  from the shipped artifact against the JAX package's remat step
  (``jax.checkpoint`` per block, as ``tests/test_model.py`` holds its own
  remat): the six losses within 1e-5 relative; every trainable leaf's
  gradient (read back from Adam's first moment) within ``1e-4 |g_jax| +
  1e-6 G`` in its 2-norm, G the global gradient norm (the rule of
  ``tests/test_torch_train_model.py``); every updated parameter within 2e-6
  of the JAX package's where the two gradients agree in sign beyond doubt
  (|g_jax| > 10 |g - g_jax| and |g_jax| > 1e-6, far above Adam's eps), and a
  leaf with no element in doubt within 1e-5 relative in its 2-norm.  Adam's
  first step moves an element by lr * g / (|g| + eps), about lr * sign(g),
  so an element whose gradient is rounding noise may move by lr in either
  direction in either package: with the backbone trainable these are many
  (every ``_bn2`` bias of the backbone reaches the loss only through
  training-mode BNs, which remove a constant shift); they are held to 2 lr
  (and two float32 steps of the parameter, the rounding of p + update).
  The running statistics within 1e-5 relative.
"""

import dataclasses
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
from hmd_ego_pose_tpu.ops.augment_device import augment_and_preprocess_batch
from hmd_ego_pose_tpu.train import checkpoint as jax_checkpoint
from hmd_ego_pose_tpu.train.state import make_optimizer
from hmd_ego_pose_tpu.train.step import _compute_losses, effective_loss_config
from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
from hmd_ego_pose_tpu_torch.models.efficientnet import MBConv
from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose, init_weights
from hmd_ego_pose_tpu_torch.models.weights import to_jax_params
from hmd_ego_pose_tpu_torch.nn.core import sigmoid, swish
from hmd_ego_pose_tpu_torch.train.checkpoint import restore_checkpoint
from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES
from hmd_ego_pose_tpu_torch.train.trainer import Trainer
from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "trained", "syn1000_phi0_576ep_handrel_int8.npz")
SIZE, BATCH, LR = 128, 2, 1e-4
TERMS = ("total", "classification", "regression", "rotation", "translation", "hand")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _forward_backward(model, x):
    """Outputs, gradients, running statistics and block forward calls of one training forward + backward."""
    calls = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: calls.append(1)) for m in model.modules()
             if isinstance(m, MBConv)]
    model.train()
    out = model(x, generator=torch.Generator().manual_seed(3))
    heads = (out.classification, out.regression, out.rotation, out.translation_raw, out.hand)
    sum(t.abs().sum() for t in heads).backward()
    for h in hooks:
        h.remove()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    return [t.detach() for t in heads], grads, stats, len(calls)


def test_remat_matches_the_plain_forward_and_moves_bn_statistics_once():
    cfg = ModelConfig(image_size=SIZE)
    plain = init_weights(HMDEgoPose(cfg), torch.Generator().manual_seed(0))
    remat = HMDEgoPose(dataclasses.replace(cfg, remat_backbone=True))
    remat.load_state_dict(plain.state_dict())
    before = {k: v.clone() for k, v in plain.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    x = torch.from_numpy(np.random.RandomState(0).normal(size=(2, 3, SIZE, SIZE)).astype(np.float32))
    outs, grads, stats, calls = _forward_backward(plain, x)
    r_outs, r_grads, r_stats, r_calls = _forward_backward(remat, x)
    blocks = len(remat.backbone_net.model._blocks)
    assert calls == blocks and r_calls == 2 * blocks
    for a, b in zip(r_outs, outs):
        assert torch.equal(a, b)
    assert r_grads.keys() == grads.keys() and len(grads) > 0
    for k, g in grads.items():
        assert torch.equal(r_grads[k], g), k
    moved = [k for k, v in stats.items() if not torch.equal(v, before[k])]
    assert any(k.startswith("backbone_net.") for k in moved)
    for k, v in stats.items():
        assert torch.equal(r_stats[k], v), k


def test_sigmoid_and_swish_gradients_match_jax_where_exp_overflows():
    x = np.array([-200.0, -90.0, -88.5, -30.0, -1.5, 0.0, 0.25, 3.0, 40.0, 100.0], np.float32)
    for fn, jax_fn in ((sigmoid, jax.nn.sigmoid), (swish, lambda v: v * jax.nn.sigmoid(v))):
        t = torch.from_numpy(x).requires_grad_(True)
        y = fn(t, torch.float32)
        y.backward(torch.ones_like(y))
        want_y, vjp = jax.vjp(jax_fn, jnp.asarray(x))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=1e-6, atol=1e-30)
        got = t.grad.numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(vjp(jnp.ones_like(want_y))[0]), rtol=1e-6, atol=1e-30)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("remat") / "syn")
    cli.main(["make-synthetic", "--out-dir", root, "--num-frames", "8", "--frame-size", str(SIZE),
              "--hand-render-version", "3"])
    return root


def test_remat_step_matches_the_jax_remat_step(dataset):
    idx = np.array([3, 0])
    params, bn_state, _ = jax_checkpoint.restore_checkpoint(ARTIFACT)
    jcfg = JaxConfig(model=JaxModelConfig(image_size=SIZE, hand_relative=True, remat_backbone=True),
                     train=JaxTrainConfig(batch_size=BATCH, learning_rate=LR, freeze_backbone=False),
                     data=JaxDataConfig(use_6dof_augmentation=False, use_colorspace_augmentation=False, preload=False))
    jds = JaxColibriDataset(dataset, 0, 1, "train")
    raw = gather_raw_batch(upload_window(build_host_cache(jds, 1)), jnp.asarray(idx))
    batch = augment_and_preprocess_batch(jax.random.PRNGKey(0), raw, SIZE, use_colorspace=False, use_6dof=False)
    grad_fn = jax.jit(jax.value_and_grad(_compute_losses, has_aux=True), static_argnums=(5, 6, 7))
    (_, (bundle, new_bn)), grads = grad_fn(params, bn_state, batch, None,
                                           jds.model_points_for_loss(jcfg.train.loss.num_model_points),
                                           jcfg.model, effective_loss_config(jcfg), jcfg.train)
    tx = make_optimizer(jcfg.train, params)
    updates, _ = tx.update(grads, tx.init(params), params)
    want_params = jax.tree.map(lambda p, u: np.asarray(p + u), params, updates)
    want_losses = [float(v) for v in (bundle.total, bundle.classification, bundle.regression, bundle.rotation,
                                      bundle.translation, bundle.hand)]

    tparams, tbn, _ = restore_checkpoint(ARTIFACT, "cpu")
    cfg = Config(model=ModelConfig(image_size=SIZE, hand_relative=True, remat_backbone=True),
                 train=TrainConfig(batch_size=BATCH, learning_rate=LR, freeze_backbone=False, checkpoint_dir="unused"),
                 data=DataConfig(use_6dof_augmentation=False, use_colorspace_augmentation=False))
    t = Trainer(cfg, ColibriDataset(dataset, 0, 1, "train"), None, device="cpu", logger=MetricLogger(stdout=False),
                params=tparams, bn_state=tbn)
    metrics = t.step_fn(t.data, torch.from_numpy(idx), None, None)
    for term, name, w in zip(TERMS, METRIC_NAMES, want_losses):
        assert float(metrics[name]) == pytest.approx(w, rel=1e-5), term
    got_params, got_bn = to_jax_params(t.model.state_dict(), cfg.model)
    mu = t.optimizer.leaves()[7:7 + len(t.optimizer.entries)]  # Adam's first moment: (1 - b1) g after one step
    g_norm = np.sqrt(sum(np.sum(np.asarray(g) ** 2) for g in jax.tree.leaves(grads)))
    off = []
    for (key, path, _), m in zip(t.optimizer.entries, mu):
        got, want, g_jax, p0 = got_params, want_params, grads, params
        for p in path:
            got, want, g_jax, p0 = got[p], want[p], g_jax[p], p0[p]
        g_jax, g = np.asarray(g_jax), m / np.float32(1 - 0.9)
        if not np.linalg.norm(g - g_jax) <= 1e-4 * np.linalg.norm(g_jax) + 1e-6 * g_norm:
            off.append(f"{key}: gradient")
        # Adam's first step moves an element by lr * g / (|g| + eps), ~lr * sign(g):
        # where the gradients' difference could flip the sign, or |g| is near
        # eps (1e-8), by up to lr either way
        certain = (np.abs(g_jax) > 10 * np.abs(g - g_jax)) & (np.abs(g_jax) > 1e-6)
        step_off = np.abs((got - np.asarray(p0)) - (want - np.asarray(p0)))
        if not (step_off[certain].max(initial=0) <= 2e-6
                and (step_off <= 2 * LR + 2 * np.spacing(np.abs(np.asarray(p0)))).all()):
            off.append(f"{key}: update")
        if certain.all() and not np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want):
            off.append(f"{key}: parameters")
    assert not off, off
    assert any(k.startswith("backbone_net.") for k, _, _ in t.optimizer.entries)  # the backbone trained
    for g, w in zip(jax.tree.leaves(got_bn), jax.tree.leaves(new_bn)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)
