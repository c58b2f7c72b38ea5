"""The iter-1 paths of the port's CLI against the JAX package: the checkpoint,
``evaluate --iter 1 --save-images-path`` and a training step at ``iter_steps=1``.

* ``chip_smoke.add_iter_leaves`` and the reference script's copy
  (``scripts/make_cli_reference.py``) draw the same leaves for the same keys;
  the port's template (``to_jax_params`` of an ``iter_steps=1`` model) has the
  JAX package's leaves and shapes; the port's int8 save of the iter-1 tree
  (``chip_smoke.write_iter1_checkpoint`` on the CPU) has the content of the
  JAX package's int8 save of the same tree, which is the digest
  ``cli_rest.json`` holds for the card.
* ``cli evaluate --iter 1 --save-images-path --device cpu`` of that
  checkpoint on the val frames of a 24-frame v3 set at 256 px against the
  JAX package's ``evaluate_model`` with ``save_path``: scalars within the
  card's tolerances (``chip_smoke.EVAL_TOLERANCES``), the same ``det_`` and
  ``samplevis_`` file names, one pair per true positive, and each ``det_``
  overlay within the stated bound of the JAX package's (PIL): at most 2 % of
  the drawn pixels differ, each differing pixel within one pixel of a pixel
  the JAX overlay drew in the same colour (the two evaluations' poses differ
  by float32 rounding, which can move a line's truncated end by a pixel).
* One training step of ``cli train --iter 1``'s trainer from that checkpoint
  (phi-0, 128 px, batch 2, augmentation and drop-connect off) against
  ``jax.value_and_grad`` of the JAX package's loss at ``iter_steps=1``: the
  six loss terms within 1e-5 relative, every trainable leaf's gradient
  (the iterative subnets' included) within ``1e-4 |g| + 1e-6 G`` in its
  2-norm, and the BN statistics after the step (each refinement step's own
  included) within 1e-5 relative, as ``tests/test_torch_train_model.py``
  holds the iter-0 step.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from hmd_ego_pose_tpu.config import Config as JaxConfig
from hmd_ego_pose_tpu.config import DataConfig as JaxDataConfig
from hmd_ego_pose_tpu.config import ModelConfig as JaxModelConfig
from hmd_ego_pose_tpu.config import TrainConfig as JaxTrainConfig
from hmd_ego_pose_tpu.data.colibri import ColibriDataset as JaxColibriDataset
from hmd_ego_pose_tpu.data.device_dataset import build_host_cache, gather_raw_batch, upload_window
from hmd_ego_pose_tpu.data.pipeline import InputPipeline as JaxInputPipeline
from hmd_ego_pose_tpu.eval import evaluator as jax_evaluator
from hmd_ego_pose_tpu.models import hmd_ego_pose as jax_model
from hmd_ego_pose_tpu.ops.augment_device import augment_and_preprocess_batch
from hmd_ego_pose_tpu.train import checkpoint as jax_checkpoint
from hmd_ego_pose_tpu.train.step import _compute_losses, effective_loss_config, make_eval_forward
from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.config import ModelConfig
from hmd_ego_pose_tpu_torch.data.image import read_png
from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
from hmd_ego_pose_tpu_torch.models.weights import to_jax_params
from hmd_ego_pose_tpu_torch.train.checkpoint import _flatten
from hmd_ego_pose_tpu_torch.train.step import compute_losses

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TERMS = ("total", "classification", "regression", "rotation", "translation", "hand")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def iter1(tmp_path_factory):
    """The port's int8 iter-1 checkpoint, written on the CPU."""
    path, _, _ = chip_smoke.write_iter1_checkpoint(str(tmp_path_factory.mktemp("iter1")), "cpu")
    return path


@pytest.fixture(scope="module")
def v3(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("v3") / "syn")
    cli.main(["make-synthetic", "--out-dir", root, "--num-frames", "24", "--frame-size", "256",
              "--hand-render-version", "3"])
    return root


def _flat(params, bn_state):
    return {**{"params/" + k: v for k, v in _flatten(params).items()},
            **{"bn/" + k: v for k, v in _flatten(bn_state).items()}}


def test_iter1_checkpoint_is_the_jax_packages(iter1, tmp_path):
    spec = importlib.util.spec_from_file_location("make_cli_reference",
                                                  os.path.join(REPO, "scripts", "make_cli_reference.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert (script.ITER_SEED, script.ITER_SCALE) == (chip_smoke.ITER_SEED, chip_smoke.ITER_SCALE)

    cfg = ModelConfig(phi=0, iter_steps=1)
    template = _flat(*to_jax_params(HMDEgoPose(cfg).state_dict(), cfg))
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), JaxModelConfig(phi=0, iter_steps=1)))
    jax_template = _flat(*shapes)
    assert {k: tuple(v.shape) for k, v in template.items()} == {k: tuple(v.shape) for k, v in jax_template.items()}

    params, bn_state, meta = jax_checkpoint.restore_checkpoint(chip_smoke.ARTIFACT)
    flat = {k: np.asarray(v) for k, v in _flat(params, bn_state).items()}
    ours, theirs = chip_smoke.add_iter_leaves(flat, template), script.add_iter_leaves(flat, jax_template)
    assert sorted(ours) == sorted(theirs) and len(ours) - len(flat) == 75
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k

    jax_path = jax_checkpoint.save_checkpoint(
        str(tmp_path), "jax_iter1", jax_checkpoint._unflatten({k[7:]: v for k, v in theirs.items() if k[:7] == "params/"}),
        jax_checkpoint._unflatten({k[3:]: v for k, v in theirs.items() if k[:3] == "bn/"}),
        metadata={"hand_relative": meta["hand_relative"]}, backend="int8")
    assert chip_smoke.npz_digest(iter1) == chip_smoke.npz_digest(jax_path)
    with open(chip_smoke.CLI_REFERENCE) as f:
        assert chip_smoke.npz_digest(iter1) == json.load(f)["iter1_checkpoint"]["npz_digest"]


def _differing(got, want, base):
    """(pixels where the overlays differ, pixels the JAX overlay drew, the
    differing pixels whose drawn colour on one side has no pixel of that colour
    within one pixel on the other side)."""
    diff = np.argwhere(np.any(got != want, axis=-1))
    far = []
    for y, x in diff:
        for a, b in ((got, want), (want, got)):
            colour = a[y, x]
            if np.array_equal(colour, base[y, x]):
                continue  # not drawn on this side
            window = b[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2]
            if not np.all(window == colour, axis=-1).any():
                far.append((int(y), int(x)))
    return len(diff), int(np.any(want != base, axis=-1).sum()), far


def test_cli_evaluate_iter1_with_images_matches_jax(v3, iter1, tmp_path):
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    got = cli.main(["evaluate", "--dataset-path", v3, "--ckpt", iter1, "--partition", "val", "--iter", "1",
                    "--save-images-path", port_dir, "--device", "cpu"])
    params, bn_state, meta = jax_checkpoint.restore_checkpoint(iter1)
    jcfg = JaxConfig(model=JaxModelConfig(phi=0, image_size=256, iter_steps=1, hand_relative=True))
    ds = JaxColibriDataset(v3, 0, 1, "val")
    want = jax_evaluator.evaluate_model(ds, make_eval_forward(jcfg, score_threshold=0.5), params, bn_state, jcfg,
                                        save_path=jax_dir)
    assert want.num_matched > 0
    for name, w in want.scalars().items():
        tol = chip_smoke.EVAL_TOLERANCES[chip_smoke.scalar_kind(name)]
        assert abs(got.scalars()[name] - w) <= tol, (name, got.scalars()[name], w)
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir))
    det = [n for n in names if n.startswith("det_")]
    assert len(det) == want.num_matched and len(names) == 2 * len(det)
    for name in det:
        i = int(name[4:10])
        with Image.open(os.path.join(jax_dir, name)) as im:
            jax_overlay = np.asarray(im)
        differ, drawn, far = _differing(read_png(os.path.join(port_dir, name)), jax_overlay,
                                               ds.load_image(i))
        assert differ <= 0.02 * drawn and not far, (name, differ, drawn, far)
        assert read_png(os.path.join(port_dir, "samplevis_" + name[4:])).shape == (800, 800, 3)


SIZE, BATCH = 128, 2


def test_one_training_step_at_iter1_matches_jax(v3, iter1, tmp_path):
    args = cli.build_parser().parse_args(["train", "--dataset-path", v3, "--ckpt", iter1, "--iter", "1",
                                          "--img-size", str(SIZE), "--batch-size", str(BATCH), "--device", "cpu"])
    t = cli.build_trainer(args, checkpoint_dir=str(tmp_path / "ckpt"))
    assert t.config.model.iter_steps == 1 and t.config.model.hand_relative
    step = t.step_fn
    idx = t.pipeline.epoch_indices(t.config.train.oversample)[0]
    batch = step.prepare(t.data, torch.from_numpy(idx), None)
    bundle = compute_losses(t.model, batch, step.model_points, t.config, step.loss_cfg, step.anchors,
                            step.trans_anchors)
    bundle.total.backward()
    got = [float(v.detach()) for v in (bundle.total, bundle.classification, bundle.regression, bundle.rotation,
                                       bundle.translation, bundle.hand)]

    params, bn_state, meta = jax_checkpoint.restore_checkpoint(iter1)
    cfg = JaxConfig(model=JaxModelConfig(phi=0, image_size=SIZE, iter_steps=1, hand_relative=True),
                    train=JaxTrainConfig(batch_size=BATCH),
                    data=JaxDataConfig(dataset_path=v3, use_6dof_augmentation=False,
                                       use_colorspace_augmentation=False, preload=False))
    ds = JaxColibriDataset(v3, 0, 1, "train")
    jidx = JaxInputPipeline(ds, cfg.data, cfg.model, BATCH, seed=cfg.train.seed).epoch_indices(cfg.train.oversample)[0]
    np.testing.assert_array_equal(jidx, idx)
    jbatch = augment_and_preprocess_batch(jax.random.PRNGKey(0), gather_raw_batch(upload_window(build_host_cache(ds, 1)),
                                                                                  jnp.asarray(jidx)),
                                          SIZE, use_colorspace=False, use_6dof=False)
    grad_fn = jax.jit(jax.value_and_grad(_compute_losses, has_aux=True), static_argnums=(5, 6, 7))
    (_, (jb, new_bn)), grads = grad_fn(params, bn_state, jbatch, None,
                                       ds.model_points_for_loss(cfg.train.loss.num_model_points), cfg.model,
                                       effective_loss_config(cfg), cfg.train)
    want = [float(v) for v in (jb.total, jb.classification, jb.regression, jb.rotation, jb.translation, jb.hand)]
    for term, g, w in zip(TERMS, got, want):
        assert g == pytest.approx(w, rel=1e-5), term

    grads_t = {k: p.grad for k, p in t.model.named_parameters() if p.grad is not None}
    assert len(grads_t) == len(step.optimizer.entries)
    assert sum(".iterative_submodel." in k for k in grads_t) > 0
    diffs = {}
    for key, path, kind in step.optimizer.entries:
        g = grads_t[key].permute(2, 3, 1, 0) if kind == "conv" else grads_t[key]
        node = grads
        for p in path:
            node = node[p]
        node = np.asarray(node)
        diffs[key] = (np.linalg.norm(g.numpy() - node), np.linalg.norm(node))
    total = np.sqrt(sum(n ** 2 for _, n in diffs.values()))
    off = {k: d for k, (d, n) in diffs.items() if not d <= 1e-4 * n + 1e-6 * total}
    assert not off, off
    _, bn = to_jax_params(t.model.state_dict(), t.config.model)
    leaves, want_leaves = jax.tree.leaves(bn), jax.tree.leaves(jax.tree.map(np.asarray, new_bn))
    assert len(leaves) == len(want_leaves)
    for g, w in zip(leaves, want_leaves):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
