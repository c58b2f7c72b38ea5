"""The port's training ops against the JAX package's, on the same seeded numpy inputs.

* IoU: ``iou_matrix_reference`` against ``iou_matrix_pallas(interpret=True)``
  and the eager jnp reference bit for bit; within 1e-6 relative (a few ulp)
  of the jitted jnp reference and of the kernel vmapped over a batch, whose
  fused XLA:CPU code rounds about 2% of the quotients differently;
* targets: ``assign_targets_batch`` state, labels and the chosen ground
  truth equal; regression, transformation and hand targets within 1e-6,
  including the forced-positive scatter with a repeated index;
* losses: each of the six terms of ``total_loss`` within 1e-5 relative,
  including more positives than the cap and symmetric objects;
* training-mode batch norm (outputs and running statistics within 1e-5) and
  drop-connect at a fixed mask;
* the optimizer: three steps of Adam, SGD-Nesterov and the global-norm clip,
  with and without the frozen backbone, against optax on fixed gradients:
  parameters and every optimizer leaf within 1e-5 relative in the leaf's
  2-norm, the backbone bit-identical.  The formulas are the same, the
  roundings are not (torch's Adam moves its first moment with ``lerp`` and
  divides by ``sqrt(v) / sqrt(1 - b2^t) + eps``): a zero-initialised bias,
  which holds nothing but three updates, differs by up to 2e-6 relative;
* the plateau scheduler, the sampler's epoch indices, the loss model points
  and the gathered batch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmd_ego_pose_tpu import losses as jax_losses
from hmd_ego_pose_tpu.config import DataConfig as JaxDataConfig
from hmd_ego_pose_tpu.config import LossConfig as JaxLossConfig
from hmd_ego_pose_tpu.config import ModelConfig as JaxModelConfig
from hmd_ego_pose_tpu.config import TrainConfig as JaxTrainConfig
from hmd_ego_pose_tpu.data import device_dataset as jax_device_dataset
from hmd_ego_pose_tpu.data.colibri import ColibriDataset as JaxColibriDataset
from hmd_ego_pose_tpu.data.pipeline import InputPipeline as JaxInputPipeline
from hmd_ego_pose_tpu.models import efficientnet as jax_efficientnet
from hmd_ego_pose_tpu.models import hmd_ego_pose as jax_model
from hmd_ego_pose_tpu.nn import core as jax_core
from hmd_ego_pose_tpu.ops import iou as jax_iou
from hmd_ego_pose_tpu.ops import target_assign as jax_targets
from hmd_ego_pose_tpu.ops.anchors import anchors_for_shape
from hmd_ego_pose_tpu.ops.pallas_kernels import iou_matrix_pallas
from hmd_ego_pose_tpu.train import plateau as jax_plateau
from hmd_ego_pose_tpu.train.state import make_optimizer
from hmd_ego_pose_tpu_torch import cli, config as tcfg, losses
from hmd_ego_pose_tpu_torch.data import colibri, device_dataset
from hmd_ego_pose_tpu_torch.data.pipeline import InputPipeline
from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
from hmd_ego_pose_tpu_torch.models.weights import from_jax_params, to_jax_params
from hmd_ego_pose_tpu_torch.nn.core import BatchNorm
from hmd_ego_pose_tpu_torch.ops import iou, target_assign
from hmd_ego_pose_tpu_torch.train import plateau
from hmd_ego_pose_tpu_torch.train.state import Optimizer

ANCHORS_256 = anchors_for_shape((256, 256))[0]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _boxes(rng, b, k, size=256.0):
    xy = rng.uniform(-10, size - 8, size=(b, k, 2))
    wh = rng.uniform(2, size / 2, size=(b, k, 2))
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# IoU
# ---------------------------------------------------------------------------


def _iou_cases():
    rng = np.random.default_rng(0)
    degenerate_a = ANCHORS_256[:64].copy()
    degenerate_a[::3, 2:] = degenerate_a[::3, :2]  # zero-area anchors
    degenerate_b = _boxes(rng, 1, 5)[0]
    degenerate_b[0, 2:] = degenerate_b[0, :2]  # zero area
    degenerate_b[1] = degenerate_b[1, [2, 3, 0, 1]]  # inverted: negative area
    degenerate_b[2] = [1e4, 1e4, 1e4 + 3, 1e4 + 3]  # disjoint
    degenerate_b[3] = degenerate_a[1]  # IoU exactly 1
    return {
        "train_12276x1": (ANCHORS_256, _boxes(rng, 1, 1)[0]),
        "300x7": (_boxes(rng, 1, 300)[0], _boxes(rng, 1, 7)[0]),
        "degenerate": (degenerate_a, degenerate_b),
    }


@pytest.mark.parametrize("case", sorted(_iou_cases()))
def test_iou_plain_matches_pallas(case):
    """Bit-equal to the Pallas kernel in interpret mode and to the eager jnp
    reference (each operation rounded on its own); within 1e-6 relative of the
    jitted jnp reference, whose fused XLA:CPU code rounds some quotients differently."""
    a, b = _iou_cases()[case]
    want_pallas = np.asarray(iou_matrix_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    want_eager = np.asarray(jax_iou.iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    want_jit = np.asarray(jax.jit(jax_iou.iou_matrix)(jnp.asarray(a), jnp.asarray(b)))
    got = iou.iou_matrix_reference(torch.from_numpy(a.copy()), torch.from_numpy(b.copy())[None])[0].numpy()
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_eager)
    np.testing.assert_allclose(got, want_jit, rtol=1e-6, atol=0)


def test_iou_batch_of_three_matches_vmapped_jax():
    rng = np.random.default_rng(1)
    anchors = _boxes(rng, 3, 200)
    gt = _boxes(rng, 3, 4)
    want = np.asarray(jax.vmap(lambda x, y: iou_matrix_pallas(x, y, interpret=True))(
        jnp.asarray(anchors), jnp.asarray(gt)))
    got = iou.iou_matrix_reference(torch.from_numpy(anchors), torch.from_numpy(gt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)  # vmapped: fused by XLA:CPU
    shared = iou.iou_matrix_reference(torch.from_numpy(anchors[0]), torch.from_numpy(gt)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(shared[i], np.asarray(jax_iou.iou_matrix(anchors[0], gt[i])))


def test_iou_wrapper_checks_and_counts_no_cpu_launch():
    """The plain anchor IoU, which the plain target assignment runs (the
    one-call IoU kernel and its wrapper are retired: ``csrc/target_assign.cu``
    computes the IoU on the card): shared (N, 4) and per-image (B, N, 4)
    anchors give (B, N, K), a zero union gives 0, not NaN, and nothing
    launches or counts a launch."""
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES

    LAUNCHES.reset()
    shared = iou.iou_matrix_reference(torch.zeros((5, 4)), torch.zeros((2, 1, 4)))
    per_image = iou.iou_matrix_reference(torch.zeros((2, 5, 4)), torch.zeros((2, 1, 4)))
    assert torch.equal(shared, torch.zeros((2, 5, 1))) and torch.equal(per_image, shared)
    assert LAUNCHES.snapshot() == {}
    assert not hasattr(iou, "iou_matrix")


# ---------------------------------------------------------------------------
# target assignment
# ---------------------------------------------------------------------------


def _gt_batch(seed, b, k, size=256):
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, b, k, size)
    labels = rng.integers(0, 2, size=(b, k)).astype(np.int32)
    transformation = rng.normal(size=(b, k, 8)).astype(np.float32)
    coords = rng.normal(size=(b, k, 63)).astype(np.float32)
    valid = rng.uniform(size=(b, k)) < 0.7
    valid[0] = True
    if b > 1:
        valid[1] = False  # an image without ground truth
    return boxes, labels, transformation, coords, valid


def _hazard_batch():
    """K = 2: a valid box whose best anchor is anchor 0 (IoU 0.098, below the
    positive threshold) and a padded row, whose all -1 column also picks anchor 0;
    then the same with the rows swapped."""
    boxes = np.zeros((2, 2, 4), np.float32)
    boxes[0, 0] = [0, 0, 10, 10]
    boxes[1, 1] = [0, 0, 10, 10]
    labels = np.zeros((2, 2), np.int32)
    transformation = np.arange(2 * 2 * 8, dtype=np.float32).reshape(2, 2, 8)
    coords = np.ones((2, 2, 63), np.float32)
    valid = np.array([[True, False], [False, True]])
    return boxes, labels, transformation, coords, valid


def _repeated_best_batch():
    """K = 4: the four rows of an image are one box, so its valid rows share one
    best anchor and the padded rows another (anchor 0).  In image 1 the box is
    the hazard's (best anchor 0 at IoU 0.098), so all four rows scatter onto
    anchor 0 and the last, padded, clears its force."""
    boxes, labels, transformation, coords, _ = _gt_batch(3, 3, 4)
    boxes[:, 1:] = boxes[:, :1]
    boxes[1] = [0, 0, 10, 10]
    valid = np.array([[True, True, False, True], [False, True, True, False], [True, False, True, True]])
    return boxes, labels, transformation, coords, valid


# cases whose image is smaller than the 256 px pyramid: the anchors whose centre
# lies at or past 192 px are outside it
_IMAGE_SIZE = {"outside_image_c2": 192}


def _targets_both(anchors, gt, num_classes, image_size):
    want = jax.jit(jax_targets.assign_targets_batch, static_argnums=(6, 7))(
        jnp.asarray(anchors), *map(jnp.asarray, gt), num_classes, image_size)
    args = (torch.from_numpy(anchors), *map(torch.from_numpy, gt))
    got = target_assign.assign_targets_batch_reference(*args, num_classes=num_classes, image_size=image_size)
    # on CPU tensors the wrapper takes the plain version
    for a, b in zip(target_assign.assign_targets_batch(*args, num_classes=num_classes, image_size=image_size), got):
        assert torch.equal(a, b)
    return got, want


@pytest.mark.parametrize("name,gt,classes", [
    ("k1", _gt_batch(0, 4, 1), 1),
    ("k3_padded", _gt_batch(1, 5, 3), 2),
    ("hazard", _hazard_batch(), 1),
    ("k4_repeated_best", _repeated_best_batch(), 1),
    ("outside_image_c2", _gt_batch(2, 4, 3, size=192), 2),
])
def test_assign_targets_batch_matches_jax(name, gt, classes):
    got, want = _targets_both(ANCHORS_256, gt, classes, _IMAGE_SIZE.get(name, 256))
    np.testing.assert_array_equal(got.state.numpy(), np.asarray(want.state))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    # the chosen ground-truth row: its transformation is gathered, so equal
    np.testing.assert_array_equal(got.transformation.numpy(), np.asarray(want.transformation))
    np.testing.assert_allclose(got.regression.numpy(), np.asarray(want.regression), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.coords_3d.numpy(), np.asarray(want.coords_3d), rtol=1e-6, atol=1e-6)
    if name == "hazard":
        # XLA lands the rows in order: the padded row after the valid one
        # clears anchor 0's force; in the swapped image it stays
        assert got.state[0, 0] == 0.0 and got.state[1, 0] == 1.0
    if name == "outside_image_c2":
        outside = (ANCHORS_256[:, 0] + ANCHORS_256[:, 2]) / 2 >= 192
        assert outside.any() and bool((got.state[:, torch.from_numpy(outside)] == -1.0).all())
    if name == "k4_repeated_best":
        # image 1: the last of the rows on anchor 0 is padded, so its force goes
        assert got.state[0].eq(1.0).any() and got.state[1, 0] == 0.0 and not got.state[1].eq(1.0).any()


def test_assign_targets_wrapper_checks_and_counts_no_cpu_launch():
    from hmd_ego_pose_tpu_torch.kernels import LAUNCHES

    gt = [torch.from_numpy(x) for x in _gt_batch(0, 2, 3)]
    anchors = torch.from_numpy(ANCHORS_256[:50].copy())
    kw = dict(num_classes=1, image_size=256)
    LAUNCHES.reset()
    target_assign.assign_targets_batch(anchors, *gt, **kw)
    assert LAUNCHES.get("target_assign") == 0
    for i, bad in enumerate([anchors.double(), gt[0].double(), gt[1].long(), gt[2].half(), gt[3].double(),
                             gt[4].int()]):
        args = [anchors, *gt]
        args[i] = bad
        with pytest.raises(ValueError):
            target_assign.assign_targets_batch(*args, **kw)
    with pytest.raises(ValueError):  # mixed devices
        target_assign.assign_targets_batch(anchors.to("meta"), *gt, **kw)
    with pytest.raises(ValueError):  # no ground-truth rows
        target_assign.assign_targets_batch(anchors, *(x[:, :0] for x in gt), **kw)
    with pytest.raises(ValueError):  # rows that disagree
        target_assign.assign_targets_batch(anchors, gt[0], gt[1][:, :2], *gt[2:], **kw)


def test_forced_positive_last_row_wins_at_k4():
    best = torch.tensor([[3, 3, 1, 3], [0, 2, 2, 5]])
    valid = torch.tensor([[True, True, True, False], [True, False, True, True]])
    got = target_assign._forced_positive(best, valid, 6).numpy()
    want = np.asarray(jax.vmap(lambda i, v: jnp.zeros((6,), bool).at[i].set(v, mode="drop"))(
        jnp.asarray(best.numpy()), jnp.asarray(valid.numpy())))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _loss_inputs(seed, b=3, n=400, c=1, positives=30, sym_every=0):
    rng = np.random.default_rng(seed)
    state = np.zeros((b, n), np.float32)
    for i in range(b):
        state[i, rng.choice(n, positives, replace=False)] = 1.0
        state[i, rng.choice(n, 40, replace=False)] = -1.0
    state[-1] = np.where(state[-1] == 1.0, 0.0, state[-1])  # an image without positives
    labels = np.zeros((b, n, c), np.float32)
    labels[..., 0] = state == 1.0
    transformation = np.concatenate([
        rng.uniform(-1, 1, (b, n, 3)), rng.normal(0, 100, (b, n, 3)) + [0, 0, 600],
        np.zeros((b, n, 1)), rng.integers(0, c, (b, n, 1))], axis=-1).astype(np.float32)
    if sym_every:
        transformation[:, ::sym_every, 6] = 1.0
    targets = (labels, rng.normal(size=(b, n, 4)).astype(np.float32), transformation,
               rng.normal(size=(b, n, 63)).astype(np.float32), state)
    outputs = (rng.uniform(0, 1, (b, n, c)).astype(np.float32), rng.normal(size=(b, n, 4)).astype(np.float32),
               rng.uniform(-1, 1, (b, n, 3)).astype(np.float32),
               (rng.normal(0, 100, (b, n, 3)) + [0, 0, 600]).astype(np.float32),
               rng.normal(size=(b, n, 63)).astype(np.float32))
    points = rng.uniform(-50, 50, (c, 60, 3)).astype(np.float32)
    return targets, outputs, points


@pytest.mark.parametrize("case,cap,sym_every,classes", [
    ("below_cap", 64, 0, 1),
    ("above_cap", 8, 0, 1),  # 30 positives, 8 read: the same 8 lowest indices
    ("symmetric_two_classes", 64, 3, 2),
])
def test_total_loss_matches_jax(case, cap, sym_every, classes):
    targets, outputs, points = _loss_inputs(3, c=classes, sym_every=sym_every)
    cfg = JaxLossConfig(max_positive_anchors=cap)
    want = jax.jit(jax_losses.total_loss, static_argnames="config")(
        jax_targets.AnchorTargets(*map(jnp.asarray, targets)), *map(jnp.asarray, outputs), points, config=cfg)
    got = losses.total_loss(target_assign.AnchorTargets(*map(torch.from_numpy, targets)),
                            *map(torch.from_numpy, outputs), torch.from_numpy(points),
                            config=tcfg.LossConfig(max_positive_anchors=cap))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)


def test_positive_slice_is_lax_top_k_order():
    state = np.zeros((2, 50), np.float32)
    state[0, [3, 7, 7 + 20, 40, 41]] = 1.0
    state[1, 10:45] = 1.0
    for cap in (4, 8, 50):
        want = np.asarray(jax.vmap(lambda s: jax.lax.top_k(jnp.where(s == 1.0, 1.0, 0.0), cap)[1])(state))
        np.testing.assert_array_equal(losses.positive_slice(torch.from_numpy(state), cap).numpy(), want)


# ---------------------------------------------------------------------------
# batch norm (training) and drop-connect
# ---------------------------------------------------------------------------


def test_training_batch_norm_matches_jax():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 9, 7, 5)) * 3 + 1).astype(np.float32)  # NHWC
    params = {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32), "bias": rng.normal(size=5).astype(np.float32)}
    state = {"mean": rng.normal(size=5).astype(np.float32), "var": rng.uniform(0.5, 2, 5).astype(np.float32)}
    y, new_state = jax_core.batch_norm_apply(params, state, jnp.asarray(x), training=True)
    bn = BatchNorm(5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(state["mean"]))
        bn.running_var.copy_(torch.from_numpy(state["var"]))
    bn.train()
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new_state["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new_state["var"]), rtol=1e-5, atol=1e-6)
    bn.eval()  # eval mode reads the moved statistics
    y_eval, _ = jax_core.batch_norm_apply(params, new_state, jnp.asarray(x), training=False)
    np.testing.assert_allclose(bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y_eval), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def phi0_trees():
    """Seeded phi-0 trees in the JAX layout (the port's init carried across)."""
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import init_weights

    model = init_weights(HMDEgoPose(tcfg.ModelConfig(phi=0, image_size=128)), torch.Generator().manual_seed(0))
    params, state = to_jax_params(model.state_dict(), model.config)
    rng = np.random.default_rng(0)  # BN statistics off their identity defaults
    state = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), state)
    return params, state


def test_drop_connect_at_a_fixed_mask_matches_jax(phi0_trees):
    params, state = phi0_trees
    specs = jax_efficientnet.block_specs(0)
    i = next(j for j, s in enumerate(specs) if j > 3 and s["stride"] == 1 and s["in_ch"] == s["out_ch"])
    spec, rate, key = specs[i], 0.2 * i / len(specs), jax.random.PRNGKey(7)
    x = np.random.default_rng(5).normal(size=(6, 8, 8, spec["in_ch"])).astype(np.float32)
    y, _ = jax_efficientnet._mbconv_apply(params["backbone"]["blocks"][i], state["backbone"]["blocks"][i],
                                         jnp.asarray(x), spec, True, rate, key, None)
    mask = np.asarray(jax.random.bernoulli(key, 1.0 - rate, (6, 1, 1, 1))).reshape(6)
    assert 0 < mask.sum() < 6  # both kept and dropped examples
    model = HMDEgoPose(tcfg.ModelConfig(phi=0, image_size=128))
    model.load_state_dict(from_jax_params(params, state, model.config))
    block = model.backbone_net.model._blocks[i].train()
    got = block(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(mask), 1.0 - rate)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(y), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def _assert_leaf_close(got, want, rel=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = np.linalg.norm(want.astype(np.float64))
    if scale == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.linalg.norm(got.astype(np.float64) - want) <= rel * scale


@pytest.mark.parametrize("fine_tune,freeze,clip", [
    (False, True, 0.0), (False, False, 1.0), (True, True, 0.0), (True, False, 0.5),
])
def test_optimizer_three_steps_match_optax(phi0_trees, fine_tune, freeze, clip):
    params, state = phi0_trees
    jcfg = JaxTrainConfig(fine_tune=fine_tune, freeze_backbone=freeze, clip_grad_norm=clip, learning_rate=3e-3)
    tx = make_optimizer(jcfg, params)
    opt_state, update = tx.init(params), jax.jit(tx.update)
    model = HMDEgoPose(tcfg.ModelConfig(phi=0, image_size=128))
    model.load_state_dict(from_jax_params(params, state, model.config))
    opt = Optimizer(model, tcfg.TrainConfig(fine_tune=fine_tune, freeze_backbone=freeze, clip_grad_norm=clip,
                                            learning_rate=3e-3), model.config)
    jparams = params
    rng = np.random.default_rng(8)
    for _ in range(3):
        grads = jax.tree.map(lambda p: rng.normal(0, 0.05, p.shape).astype(np.float32), jparams)
        updates, opt_state = update(grads, opt_state, jparams)
        jparams = jax.tree.map(lambda p, u: np.asarray(p + u), jparams, updates)
        tgrads = from_jax_params(grads, state, model.config)
        for key, p in model.named_parameters():
            if p.requires_grad:
                p.grad = tgrads[key].clone()
        opt.step()
    got_params, _ = to_jax_params(model.state_dict(), model.config)
    for g, w in zip(jax.tree.leaves(got_params), jax.tree.leaves(jparams)):
        _assert_leaf_close(g, w)
    if freeze:
        for g, w in zip(jax.tree.leaves(got_params["backbone"]), jax.tree.leaves(params["backbone"])):
            np.testing.assert_array_equal(g, w)
    want_leaves = jax.tree.leaves(opt_state)
    got_leaves = opt.leaves()
    assert len(got_leaves) == len(want_leaves) == opt.num_leaves()
    for g, w in zip(got_leaves, want_leaves):
        _assert_leaf_close(g, w)


# ---------------------------------------------------------------------------
# plateau, sampler, data
# ---------------------------------------------------------------------------


def test_plateau_matches_jax():
    metrics = [10, 9, 9.5, 9.4, 9.3, 9.2, 9.1, 9.0005, 8, 8.5, 8.6, 8.7, 8.8, 8.9, 9.0, 9.1, 7.0]
    for n_epochs in (1, 2, 3):
        a = jax_plateau.ReduceLROnPlateau(1e-3, patience=3, min_lr=2e-4)
        b = plateau.ReduceLROnPlateau(1e-3, patience=3, min_lr=2e-4)
        assert [a.step(m, n_epochs) for m in metrics] == [b.step(m, n_epochs) for m in metrics]


@pytest.fixture(scope="module")
def small_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("syn") / "syn")
    cli.main(["make-synthetic", "--out-dir", root, "--num-frames", "10", "--frame-size", "96",
              "--hand-render-version", "3"])
    return root


def test_epoch_indices_model_points_and_batch_match_jax(small_set):
    jds, tds = JaxColibriDataset(small_set, 0, 1, "train"), colibri.ColibriDataset(small_set, 0, 1, "train")
    jpipe = JaxInputPipeline(jds, JaxDataConfig(preload=False), JaxModelConfig(image_size=96), batch_size=3, seed=5)
    tpipe = InputPipeline(tds, tcfg.DataConfig(), batch_size=3, seed=5)
    for oversample in (1, 3, 2):
        np.testing.assert_array_equal(tpipe.epoch_indices(oversample), jpipe.epoch_indices(oversample))
    np.testing.assert_array_equal(tds.model_points_for_loss(500), jds.model_points_for_loss(500))
    np.testing.assert_array_equal(tds.model_points_for_loss(7), jds.model_points_for_loss(7))
    for i in range(len(tds)):
        np.testing.assert_array_equal(tds.load_mask(i), jds.load_mask(i))
    jcache, tcache = jax_device_dataset.build_host_cache(jds, 1), device_dataset.build_host_cache(tds, 1)
    for a, b in zip(tcache, jcache):
        np.testing.assert_array_equal(a, b)
    idx = np.array([4, 0, 2])
    want = jax_device_dataset.gather_raw_batch(jax_device_dataset.upload_window(jcache), jnp.asarray(idx))
    got = device_dataset.gather_raw_batch(device_dataset.upload_window(tcache, None, torch.device("cpu")),
                                          torch.from_numpy(idx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_preload_serves_the_same_frames(small_set):
    ds = colibri.ColibriDataset(small_set, 0, 1, "val")
    before = [ds.load_image(i) for i in range(len(ds))], [ds.load_mask(i) for i in range(len(ds))]
    assert ds.preload() and ds.preload()
    assert not colibri.ColibriDataset(small_set, 0, 1, "val").preload(budget_bytes=10)
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds.load_image(i), before[0][i])
        np.testing.assert_array_equal(ds.load_mask(i), before[1][i])


def test_train_config_copy_matches_jax():
    for ours, theirs in ((tcfg.LossConfig(), JaxLossConfig()), (tcfg.TrainConfig(), JaxTrainConfig()),
                         (tcfg.DataConfig(), JaxDataConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert {f.name for f in dataclasses.fields(tcfg.ModelConfig)} == {
        f.name for f in dataclasses.fields(JaxModelConfig)}
