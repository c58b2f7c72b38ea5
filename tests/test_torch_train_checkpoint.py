"""Checkpoints between the port and the JAX package, on the shipped artifact's trees.

* ``to_jax_params(from_jax_params(p, b))`` gives back ``(p, b)`` exactly;
* ``save_checkpoint`` of the port and of the JAX package write byte-equal
  ``.npz`` files and sidecars for the same trees and optimizer state;
* a ``last`` checkpoint with optimizer leaves resumes in the other package:
  the port's in the JAX package and the JAX package's in the port, each
  then takes one more step from the same gradients as the package that
  wrote it, and the parameters agree within 1e-5 relative (the optimizer
  test's float32 bound, ``tests/test_torch_train_ops.py``);
* the int8 backend of both packages writes byte-equal files for the same
  C-ordered trees (the port quantizing with its plain version on the CPU),
  ``__format__`` first and no optimizer leaves, and each package restores
  the other's int8 file to the same leaves.
"""

import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from hmd_ego_pose_tpu.config import TrainConfig as JaxTrainConfig
from hmd_ego_pose_tpu.train import checkpoint as jax_checkpoint
from hmd_ego_pose_tpu.train.state import make_optimizer
from hmd_ego_pose_tpu_torch import config as tcfg
from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose, init_weights
from hmd_ego_pose_tpu_torch.models.weights import from_jax_params, to_jax_params
from hmd_ego_pose_tpu_torch.train import checkpoint
from hmd_ego_pose_tpu_torch.train.state import Optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "trained", "syn1000_phi0_576ep_handrel_int8.npz")
MODEL = tcfg.ModelConfig(phi=0, image_size=256, hand_relative=True)
META = {"epoch": 3, "metric": 16.5, "train_step": 12, "hand_relative": True, "config": "Config(...)"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    params, bn_state, _ = jax_checkpoint.restore_checkpoint(ARTIFACT)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, bn_state)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: rng.normal(0, 0.01, p.shape).astype(np.float32), params)


def _jax_steps(params, tx, opt_state, seeds):
    update = jax.jit(tx.update)
    for seed in seeds:
        updates, opt_state = update(_grads(params, seed), opt_state, params)
        params = jax.tree.map(lambda p, u: np.asarray(p + u), params, updates)
    return params, opt_state


def _port_steps(model, opt, bn_state, seeds):
    for seed in seeds:
        params, _ = to_jax_params(model.state_dict(), MODEL)
        grads = from_jax_params(_grads(params, seed), bn_state, MODEL)
        for key, p in model.named_parameters():
            if p.requires_grad:
                p.grad = grads[key].clone()
        opt.step()


def _model(params, bn_state):
    model = HMDEgoPose(MODEL)
    model.load_state_dict(from_jax_params(params, bn_state, MODEL), strict=True)
    return model


def _assert_trees_close(got, want, rel=1e-5):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        assert np.linalg.norm(np.asarray(g, np.float64) - w) <= rel * max(np.linalg.norm(w), 1e-30)


def test_to_jax_params_inverts_from_jax_params(trees):
    params, bn_state = trees
    back_p, back_b = to_jax_params(from_jax_params(params, bn_state, MODEL), MODEL)
    for got, want in ((back_p, params), (back_b, bn_state)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_save_checkpoint_bytes_equal_jax(trees, tmp_path):
    params, bn_state = trees
    tx = make_optimizer(JaxTrainConfig(), params)
    params1, opt_state = _jax_steps(params, tx, tx.init(params), seeds=[1])
    leaves = [np.asarray(x) for x in jax.tree.leaves(opt_state)]
    jax_path = jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), "last", params1, bn_state,
                                              metadata=META, opt_state=opt_state)
    port_path = checkpoint.save_checkpoint(str(tmp_path / "port"), "last", params1, bn_state,
                                           metadata=META, opt_leaves=leaves)
    assert filecmp.cmp(jax_path, port_path, shallow=False)
    assert filecmp.cmp(jax_path[:-4] + ".json", port_path[:-4] + ".json", shallow=False)
    # the port's own trees of the same weights (carried through the state_dict) write the same bytes
    mine = to_jax_params(_model(params1, bn_state).state_dict(), MODEL)
    again = checkpoint.save_checkpoint(str(tmp_path / "again"), "last", *mine, metadata=META, opt_leaves=leaves)
    assert filecmp.cmp(jax_path, again, shallow=False)
    with np.load(port_path) as data:
        names = data.files
    assert names[0].startswith("params/") and names[-1] == f"opt/{len(leaves) - 1:05d}"
    blocks = [n for n in names if n.startswith("params/backbone/blocks/") and n.endswith("/depthwise_conv/kernel")]
    assert blocks.index("params/backbone/blocks/9/depthwise_conv/kernel") < blocks.index(
        "params/backbone/blocks/10/depthwise_conv/kernel")


def test_port_last_checkpoint_resumes_in_jax(trees, tmp_path):
    params, bn_state = trees
    model = _model(params, bn_state)
    opt = Optimizer(model, tcfg.TrainConfig(), MODEL)
    _port_steps(model, opt, bn_state, seeds=[1, 2])
    path = checkpoint.save_checkpoint(str(tmp_path), "last", *to_jax_params(model.state_dict(), MODEL),
                                      metadata=META, opt_leaves=opt.leaves())
    # what the JAX CLI and Trainer do with it: restore, rebuild the optimizer state
    jparams, jbn, meta = jax_checkpoint.restore_checkpoint(path)
    assert meta == META
    jparams, jbn = jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray, jbn)
    tx = make_optimizer(JaxTrainConfig(), jparams)
    template = tx.init(jparams)
    leaves = jax_checkpoint.restore_opt_leaves(path)
    t_leaves, treedef = jax.tree.flatten(template)
    assert len(leaves) == len(t_leaves) == opt.num_leaves()
    opt_state = jax.tree.unflatten(treedef, [np.asarray(v).astype(t.dtype).reshape(t.shape)
                                             for v, t in zip(leaves, t_leaves)])
    assert int(np.asarray(jax.tree.leaves(opt_state)[0])) == 2
    _port_steps(model, opt, bn_state, seeds=[3])
    jparams, _ = _jax_steps(jparams, tx, opt_state, seeds=[3])
    _assert_trees_close(to_jax_params(model.state_dict(), MODEL)[0], jparams)
    for g, w in zip(jax.tree.leaves(jbn), jax.tree.leaves(bn_state)):
        np.testing.assert_array_equal(g, w)


def test_jax_last_checkpoint_resumes_in_the_port(trees, tmp_path):
    params, bn_state = trees
    cfg = JaxTrainConfig(fine_tune=True)
    tx = make_optimizer(cfg, params)
    jparams, opt_state = _jax_steps(params, tx, tx.init(params), seeds=[4, 5])
    path = jax_checkpoint.save_checkpoint(str(tmp_path), "last", jparams, bn_state, metadata=META,
                                          opt_state=opt_state)
    tparams, tbn, meta = checkpoint.restore_checkpoint(path, device="cpu")
    assert meta == META
    model = HMDEgoPose(MODEL)
    model.load_state_dict(from_jax_params(tparams, tbn, MODEL), strict=True)
    opt = Optimizer(model, tcfg.TrainConfig(fine_tune=True), MODEL)
    opt.load_leaves(checkpoint.restore_opt_leaves(path))
    assert opt.count == 2
    for g, w in zip(opt.leaves(), jax.tree.leaves(opt_state)):
        np.testing.assert_array_equal(g, np.asarray(w))
    _port_steps(model, opt, bn_state, seeds=[6])
    jparams, _ = _jax_steps(jparams, tx, opt_state, seeds=[6])
    _assert_trees_close(to_jax_params(model.state_dict(), MODEL)[0], jparams)
    with pytest.raises(ValueError, match="optimizer state mismatch"):
        Optimizer(_model(params, bn_state), tcfg.TrainConfig(), MODEL).load_leaves(
            checkpoint.restore_opt_leaves(path))


def test_checkpoint_name_and_artifact_opt_leaves(trees, tmp_path):
    assert checkpoint.checkpoint_name("syn_colibri", 0, 0, 16.3456, 7) == jax_checkpoint.checkpoint_name(
        "syn_colibri", 0, 0, 16.3456, 7)
    assert checkpoint.restore_opt_leaves(ARTIFACT) is None


@pytest.fixture(scope="module")
def seeded_trees():
    """C-ordered phi-0 trees of a seeded init, with BN statistics off identity."""
    model = init_weights(HMDEgoPose(MODEL), torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=gen) * 0.1)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    return to_jax_params(model.state_dict(), MODEL)


@pytest.mark.parametrize("leaves", ["numpy", "tensor"])
def test_int8_save_bytes_equal_jax(seeded_trees, tmp_path, leaves):
    """Byte-equal ``.npz`` (``filecmp``, tolerance 0) and sidecar; optimizer leaves are not written."""
    params, bn_state = seeded_trees
    jpath = jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), "w", params, bn_state, metadata=META,
                                           backend="int8")
    given = (params, bn_state) if leaves == "numpy" else jax.tree.map(torch.from_numpy, (params, bn_state))
    tpath = checkpoint.save_checkpoint(str(tmp_path / "port"), "w", *given, metadata=META, backend="int8",
                                       opt_leaves=[np.zeros(3, np.float32)], device="cpu")
    assert filecmp.cmp(jpath, tpath, shallow=False)
    assert filecmp.cmp(jpath[:-4] + ".json", tpath[:-4] + ".json", shallow=False)
    with np.load(tpath) as data:
        assert data.files[0] == "__format__" and str(data["__format__"]) == "int8"
        assert not any(k.startswith("opt/") for k in data.files)
        assert sum(k.endswith("/int8") for k in data.files) > 100


def test_each_package_restores_the_others_int8_file(seeded_trees, tmp_path):
    params, bn_state = seeded_trees
    jpath = jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), "w", params, bn_state, backend="int8")
    tpath = checkpoint.save_checkpoint(str(tmp_path / "port"), "w", params, bn_state, backend="int8",
                                       device="cpu")
    want = jax_checkpoint.restore_checkpoint(jpath)[:2]
    by_jax = jax_checkpoint.restore_checkpoint(tpath)[:2]
    by_port = checkpoint.restore_checkpoint(jpath, device="cpu")[:2]
    for got in (by_jax, jax.tree.map(lambda t: t.numpy(), by_port)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # the int8 round trip is lossy: within half a step of each column's scale
    restored = jax.tree.leaves(want[0])
    for g, w in zip(restored, jax.tree.leaves(params)):
        s = np.abs(w.reshape(-1, w.shape[-1])).max(axis=0) / 127
        assert np.all(np.abs(np.asarray(g) - w).reshape(-1, w.shape[-1]) <= s * 0.5 + 1e-7)


def test_int8_save_defaults_to_the_card(seeded_trees, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.save_checkpoint(str(tmp_path), "w", *seeded_trees, backend="int8")


def _mixed_tree():
    """Leaves of four dtypes, 0-d, empty and Fortran-ordered ones, in nested dicts, lists and tuples."""
    rng = np.random.default_rng(11)
    return {
        "w": rng.normal(size=(3, 4)).astype(np.float32),
        "f": np.asfortranarray(rng.normal(size=(5, 2, 3)).astype(np.float32)),
        "blocks": [{"k": rng.normal(size=(2,)).astype(np.float32), "n": np.int64(7)},
                   {"k": np.zeros((0, 3), np.float32), "n": np.arange(4, dtype=np.int64)}],
        "pair": (np.array(True), rng.integers(-128, 128, size=(2, 3), dtype=np.int8)),
        "scalar": np.float32(2.5),
        "tensor": torch.arange(6, dtype=torch.float32).reshape(2, 3),
    }


def test_pack_transfer_equals_per_leaf_uploads_with_one_copy_per_dtype():
    from hmd_ego_pose_tpu_torch.utils.device import UPLOADS, pack_transfer

    tree = _mixed_tree()
    UPLOADS.reset()
    packed = pack_transfer(tree, "cpu")
    assert UPLOADS.snapshot() == {"pack_transfer/float32": 1, "pack_transfer/int64": 1,
                                  "pack_transfer/bool": 1, "pack_transfer/int8": 1}
    assert isinstance(packed["pair"], tuple) and isinstance(packed["blocks"], list)
    assert list(packed) == list(tree)
    got, want = checkpoint._flatten(packed), checkpoint._flatten(tree)
    assert list(got) == list(want)
    for name, leaf in want.items():
        one = torch.as_tensor(np.array(np.asarray(leaf), order="C")).to("cpu")
        assert got[name].dtype == one.dtype and got[name].shape == one.shape, name
        assert torch.equal(got[name], one), name
    # the float32 leaves are views of one buffer, in tree order
    floats = [got[k] for k in ("blocks/0/k", "blocks/1/k", "f", "scalar", "tensor", "w")]
    assert len({t.untyped_storage().data_ptr() for t in floats}) == 1
    assert pack_transfer({}, "cpu") == {}


def test_packed_restore_of_the_artifact_bit_equal_to_jax():
    from hmd_ego_pose_tpu_torch.utils.device import UPLOADS

    UPLOADS.reset()
    params, bn_state, meta = checkpoint.restore_checkpoint(ARTIFACT, device="cpu")
    # one copy for the 452 float32 and 306 bn/ leaves, two for the int8 group's
    # values and scales (its table goes up only for the kernel, on the card)
    assert UPLOADS.snapshot() == {"pack_transfer/float32": 1, "dequantize_group/values": 1,
                                  "dequantize_group/scales": 1}
    want_params, want_bn, want_meta = jax_checkpoint.restore_checkpoint(ARTIFACT)
    assert meta == want_meta
    for got, want in ((params, want_params), (bn_state, want_bn)):
        got = jax.tree.map(lambda t: t.numpy(), got)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, np.asarray(w))
    assert len(jax.tree.leaves(params)) + len(jax.tree.leaves(bn_state)) == 452 + 137 + 306


def test_packed_restore_of_an_fp32_checkpoint(trees, tmp_path):
    from hmd_ego_pose_tpu_torch.utils.device import UPLOADS

    params, bn_state = trees
    path = jax_checkpoint.save_checkpoint(str(tmp_path), "fp32", params, bn_state)
    UPLOADS.reset()
    got_params, got_bn, _ = checkpoint.restore_checkpoint(path, device="cpu")
    assert UPLOADS.snapshot() == {"pack_transfer/float32": 1}
    for got, want in ((got_params, params), (got_bn, bn_state)):
        got = jax.tree.map(lambda t: t.numpy(), got)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, w)
