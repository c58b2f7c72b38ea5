"""The port's int8 dequantize and checkpoint restore against the JAX package.

The plain version (``dequantize_reference``), which the CPU path runs, must be
bit-equal to the JAX package's numpy and Pallas (interpret mode) versions;
the port's ``restore_checkpoint`` must give the JAX restore's leaves bit for
bit on both shipped artifacts.  The CUDA kernel itself is held to the plain
version by ``tests/test_torch_cuda.py``, on the card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from hmd_ego_pose_tpu.ops.quantization import dequantize_np, dequantize_pallas, quantize_np
from hmd_ego_pose_tpu.train import checkpoint as jax_checkpoint
from hmd_ego_pose_tpu_torch.kernels import LAUNCHES, build
from hmd_ego_pose_tpu_torch.ops.quantization import dequantize, dequantize_reference
from hmd_ego_pose_tpu_torch.train import checkpoint as torch_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = ("syn1000_phi0_576ep_handrel_int8", "syn1000_phi0_448ep_int8")


def _random_int8(rows, cols, seed):
    rng = np.random.default_rng(seed)
    values = rng.integers(-127, 128, size=(rows, cols), dtype=np.int8)
    scales = rng.uniform(1e-5, 0.5, size=(cols,)).astype(np.float32)
    return values, scales


@settings(max_examples=12, deadline=None)
@given(rows=st.integers(1, 70), cols=st.integers(1, 300), seed=st.integers(0, 2**16))
def test_dequantize_reference_bit_equal_to_numpy_and_pallas(rows, cols, seed):
    values, scales = _random_int8(rows, cols, seed)
    got = dequantize_reference(torch.from_numpy(values), torch.from_numpy(scales)).numpy()
    np.testing.assert_array_equal(got, dequantize_np(values, scales))
    pallas = dequantize_pallas(jnp.asarray(values), jnp.asarray(scales[None]), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


def test_dequantize_of_quantized_weights_matches_numpy():
    rng = np.random.default_rng(3)
    x = rng.normal(scale=0.2, size=(75, 48)).astype(np.float32)
    q, s = quantize_np(x)
    got = dequantize(torch.from_numpy(q), torch.from_numpy(s))  # CPU tensors: the plain version
    np.testing.assert_array_equal(got.numpy(), dequantize_np(q, s))
    np.testing.assert_array_equal(
        dequantize(torch.from_numpy(q), torch.from_numpy(s[0])).numpy(), dequantize_np(q, s)
    )


def test_dequantize_cpu_path_launches_no_kernel():
    LAUNCHES.reset()
    values, scales = _random_int8(4, 5, 0)
    dequantize(torch.from_numpy(values), torch.from_numpy(scales))
    assert LAUNCHES.get("dequantize") == 0


def test_dequantize_refuses_tensors_off_cpu_and_cuda():
    values = torch.zeros((2, 3), dtype=torch.int8, device="meta")
    scales = torch.zeros((3,), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        dequantize(values, scales)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()


def test_build_hash_tracks_the_source():
    assert build.sources() == ["dequantize", "min_distances"]
    assert sorted(build.SIGNATURES) == build.sources()
    for name in build.sources():
        path = build.library_path(name)
        assert path.startswith(build.BUILD_DIR) and path.endswith(".so")
        assert path == build.library_path(name)
    assert build.library_path("dequantize") != build.library_path("min_distances")


@pytest.mark.parametrize("name", ARTIFACTS)
def test_restore_checkpoint_matches_jax_leaf_for_leaf(name):
    path = os.path.join(REPO, "trained", name + ".npz")
    jp, jb, jmeta = jax_checkpoint.restore_checkpoint(path)
    tp, tb, tmeta = torch_checkpoint.restore_checkpoint(path, device="cpu")
    assert tmeta == jmeta
    for jtree, ttree in ((jp, tp), (jb, tb)):
        jleaves, jdef = jax.tree_util.tree_flatten(jtree)
        tleaves, tdef = jax.tree_util.tree_flatten(ttree, is_leaf=lambda x: isinstance(x, torch.Tensor))
        assert jdef == tdef
        for a, b in zip(jleaves, tleaves):
            assert b.dtype == torch.float32 and b.device.type == "cpu"
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_restore_fp32_checkpoint_matches_jax(tmp_path):
    jp, jb, _ = jax_checkpoint.restore_checkpoint(os.path.join(REPO, "trained", ARTIFACTS[0] + ".npz"))
    path = jax_checkpoint.save_checkpoint(str(tmp_path), "fp32", jp, jb, {"hand_relative": True})
    tp, tb, meta = torch_checkpoint.restore_checkpoint(path, device="cpu")
    assert meta == {"hand_relative": True}
    assert torch_checkpoint.meta_hand_relative(meta) is True
    np.testing.assert_array_equal(tp["backbone"]["stem_conv"]["kernel"].numpy(),
                                  np.asarray(jp["backbone"]["stem_conv"]["kernel"]))
    np.testing.assert_array_equal(tb["hand"]["bns"][4][2]["var"].numpy(),
                                  np.asarray(jb["hand"]["bns"][4][2]["var"]))


def test_restore_checkpoint_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_checkpoint.restore_checkpoint(os.path.join(REPO, "trained", ARTIFACTS[0] + ".npz"))

