"""The port's int8 quantize, dequantize and checkpoint restore against the JAX package.

The plain versions, which the CPU path runs, are held to the JAX package:
``dequantize_reference`` bit-equal to its numpy and Pallas (interpret mode)
versions; ``quantize_reference`` bit-equal to ``quantize_np`` (what the JAX
int8 save runs), and within one ulp of scale of ``quantize_pallas`` in
interpret mode, where XLA multiplies by float32(1/127) instead of dividing.
The port's ``restore_checkpoint`` must give the JAX restore's leaves bit for
bit on both shipped artifacts.  The CUDA kernels themselves are held to the
plain versions by ``tests/test_torch_cuda.py``, on the card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import chip_smoke
from hmd_ego_pose_tpu.ops import quantization as jax_quantization
from hmd_ego_pose_tpu.ops.quantization import dequantize_np, dequantize_pallas, quantize_np, quantize_pallas
from hmd_ego_pose_tpu.train import checkpoint as jax_checkpoint
from hmd_ego_pose_tpu_torch.kernels import LAUNCHES, build
from hmd_ego_pose_tpu_torch.ops import quantization
from hmd_ego_pose_tpu_torch.ops.quantization import dequantize, dequantize_reference, quantize, quantize_reference
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
    assert build.sources() == ["dequantize", "iou", "min_distances", "quantize"]
    assert sorted(build.SIGNATURES) == build.sources()
    for name in build.sources():
        path = build.library_path(name)
        assert path.startswith(build.BUILD_DIR) and path.endswith(".so")
        assert path == build.library_path(name)
    assert build.library_path("dequantize") != build.library_path("min_distances")


QUANT_CASES = chip_smoke.quantize_inputs()


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantize_reference_bit_equal_to_quantize_np(case):
    """Odd shapes, zero columns, exact half-steps, negative zeros, denormals:
    int8 values and scales bit for bit (tolerance 0)."""
    x = QUANT_CASES[case]
    q, s = quantize_reference(torch.from_numpy(x))
    want_q, want_s = quantize_np(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and tuple(s.shape) == (1, x.shape[1])
    np.testing.assert_array_equal(q.numpy(), want_q)
    assert s.numpy().tobytes() == want_s.tobytes()


def test_quantize_rounds_half_to_even_and_floors_zero_columns():
    q, s = quantize_reference(torch.from_numpy(QUANT_CASES["half_steps"]))
    x = QUANT_CASES["half_steps"] / s.numpy()
    assert np.all(np.abs(x[1:] - np.trunc(x[1:])) == 0.5)  # every value but the absmax row is a tie
    assert np.all(q.numpy()[1:] % 2 == 0)
    q, s = quantize_reference(torch.from_numpy(QUANT_CASES["zero_columns"]))
    assert s[0, 3].item() == s[0, 7].item() == np.float32(1e-12) / np.float32(127)
    assert not q[:, 3].any() and not q[:, 7].any()


@pytest.mark.parametrize("shape", [(27, 40), (9, 1000), (30, 1280), (1152, 320), (5, 33)])
def test_quantize_reference_within_one_ulp_of_pallas_interpret(shape):
    """The Pallas kernel's scales are ``absmax * f32(1/127)`` (XLA's rewrite of
    the division): one ulp off numpy's in a few columns.  Tolerance: scales
    within 1 ulp, int8 values within one level and different only in those
    columns; on these seeded inputs no int8 value differs (the count)."""
    x = np.random.default_rng(shape[1]).normal(0, 0.2, shape).astype(np.float32)
    q, s = quantize_reference(torch.from_numpy(x))
    pq, ps = (np.asarray(a) for a in quantize_pallas(jnp.asarray(x), interpret=True))
    ulps = np.abs(s.numpy().view(np.int32).astype(np.int64) - ps.view(np.int32))
    assert ulps.max() <= 1
    levels = np.abs(q.numpy().astype(np.int64) - pq)
    assert levels.max() <= 1
    assert not levels[:, ulps[0] == 0].any()
    assert int(np.count_nonzero(levels)) == 0


def test_quantize_of_a_nan_column_keeps_nan_in_its_scale_as_numpy():
    """A column holding NaN gets a NaN scale on both sides; the other columns
    are unchanged.  The NaN column's int8 values are an unspecified cast in
    numpy and torch alike, so they are not compared."""
    x = np.random.default_rng(1).normal(0, 0.2, (6, 5)).astype(np.float32)
    x[2, 1] = np.nan
    q, s = quantize_reference(torch.from_numpy(x))
    with np.errstate(invalid="ignore"):
        want_q, want_s = quantize_np(x)
    np.testing.assert_array_equal(np.isnan(s.numpy()), np.isnan(want_s))
    assert np.isnan(s[0, 1].item())
    keep = [0, 2, 3, 4]
    np.testing.assert_array_equal(q.numpy()[:, keep], want_q[:, keep])
    np.testing.assert_array_equal(s.numpy()[:, keep], want_s[:, keep])


def test_quantize_cpu_path_launches_no_kernel_and_refuses_other_devices():
    LAUNCHES.reset()
    q, s = quantize(torch.from_numpy(QUANT_CASES["5x33"]))
    assert LAUNCHES.get("quantize") == 0 and q.shape == (5, 33) and s.shape == (1, 33)
    with pytest.raises(ValueError):
        quantize(torch.zeros((2, 3), dtype=torch.float32, device="meta"))


def test_quantize_tree_packs_leaves_as_the_jax_package():
    """The leaf rule (< 1024 values or not float32 -> fp32) and the packed
    arrays equal ``quantize_tree`` of the JAX package, for numpy and tensor leaves."""
    rng = np.random.default_rng(2)
    tree = {"conv": {"kernel": rng.normal(0, 0.1, (3, 3, 16, 32)).astype(np.float32),
                     "bias": rng.normal(0, 0.1, (32,)).astype(np.float32)},
            "blocks": [{"w": rng.normal(0, 0.1, (1, 1, 40, 60)).astype(np.float32)},
                       {"ints": np.arange(2048, dtype=np.int32)}]}
    want = jax_quantization.quantize_tree(tree)
    for leaves in ("numpy", "tensor"):
        given = tree if leaves == "numpy" else jax.tree.map(torch.from_numpy, tree)
        got = quantization.quantize_tree(given, torch.device("cpu"))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert quantization.quantized_nbytes(got) == jax_quantization.quantized_nbytes(want)


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

