"""The port's int8 quantize, dequantize and checkpoint restore against the JAX package.

The plain versions, which the CPU path runs, are held to the JAX package:
``dequantize_reference`` bit-equal to its numpy and Pallas (interpret mode)
versions; ``quantize_reference`` bit-equal to ``quantize_np`` (what the JAX
int8 save runs), and within one ulp of scale of ``quantize_pallas`` in
interpret mode, where XLA multiplies by float32(1/127) instead of dividing.
The group plain versions, which walk a group's table over those, equal
``dequantize_np`` / ``quantize_np`` leaf by leaf on the shipped artifact's
137 int8 leaves and on a seeded mixed group, and the tables lay every leaf
out aligned and apart.  The port's ``restore_checkpoint`` (one group for
every int8 leaf) must give the JAX restore's leaves bit for bit on both
shipped artifacts, and its int8 save the JAX file's canonical digest.  The CUDA kernels themselves are held to the
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
from hmd_ego_pose_tpu_torch.export import reference
from hmd_ego_pose_tpu_torch.kernels import LAUNCHES, build
from hmd_ego_pose_tpu_torch.ops import quantization
from hmd_ego_pose_tpu_torch.ops.quantization import (dequantize, dequantize_group, dequantize_group_reference,
                                                     dequantize_reference, pack_dequantize_group,
                                                     pack_quantize_group, quantize, quantize_group,
                                                     quantize_group_reference, quantize_reference)
from hmd_ego_pose_tpu_torch.train import checkpoint as torch_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = ("syn1000_phi0_576ep_handrel_int8", "syn1000_phi0_448ep_int8")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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
    assert build.sources() == ["batch_norm", "dequantize", "min_distances", "quantize", "target_assign"]
    assert sorted(build.SIGNATURES) == build.sources()
    for name in build.sources():
        path = build.library_path(name)
        assert path.startswith(build.BUILD_DIR) and path.endswith(".so")
        assert path == build.library_path(name)
    assert build.library_path("dequantize") != build.library_path("min_distances")
    assert build.library_path("min_distances", ("HEGP_MIN_DIST_POINTS=2",)) != build.library_path("min_distances")


def _kernel_variants():
    import importlib.util

    spec = importlib.util.spec_from_file_location("time_kernel_variants",
                                                  os.path.join(REPO, "scripts", "time_kernel_variants.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.VARIANTS


@pytest.mark.parametrize("name,variant", sorted(_kernel_variants().items()))
def test_kernel_variants_override_constants_their_source_declares(name, variant):
    """Every define of a timed variant overrides an #ifndef default of its source."""
    source, defines, _ = variant
    assert source in build.SIGNATURES, name
    with open(os.path.join(build.CSRC, f"{source}.cu")) as f:
        text = f.read()
    for define in defines:
        macro, value = define.split("=")
        assert f"#ifndef {macro}\n#define {macro} " in text, (name, macro)
        assert int(value) > 0


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



def _artifact_int8_leaves():
    return [(v, s) for v, s in chip_smoke.int8_leaves(os.path.join(REPO, "trained", ARTIFACTS[0] + ".npz"))]


def _int8_group(name):
    if name == "artifact":
        return _artifact_int8_leaves()
    return [(v, s) for _, v, s in chip_smoke.mixed_int8_group()]


def _float_group(name):
    if name == "artifact":
        return [dequantize_np(v, s) for v, s in _artifact_int8_leaves()]
    return list(chip_smoke.mixed_float_group().values())


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("group", ["artifact", "mixed"])
def test_dequantize_group_reference_bit_equal_to_dequantize_np(group):
    """The shipped artifact's 137 int8 leaves, and the mixed group (odd shapes,
    zero columns, half-steps, denormal and NaN scales), packed as the kernel
    takes them: every leaf bit for bit ``dequantize_np`` (tolerance 0, NaN
    payloads and signed zeros included)."""
    leaves = _int8_group(group)
    values, scales, layout = pack_dequantize_group(leaves)
    out = dequantize_group_reference(torch.from_numpy(values), torch.from_numpy(scales), layout.table)
    for (v, s), (_, _, ooff, r, c, _) in zip(leaves, layout.table.tolist()):
        with np.errstate(invalid="ignore"):
            want = dequantize_np(v, s)
        np.testing.assert_array_equal(_bits(out[ooff:ooff + r * c].view(r, c).numpy()), _bits(want))
    got = dequantize_group(leaves, "cpu")  # the CPU path: the same packing, the plain version
    assert len(got) == len(leaves)
    for g, (_, _, ooff, r, c, _) in zip(got, layout.table.tolist()):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(out[ooff:ooff + r * c].view(r, c).numpy()))


@pytest.mark.parametrize("group", ["artifact", "mixed"])
def test_quantize_group_reference_bit_equal_to_quantize_np(group):
    """The 137 dequantized leaves of the shipped artifact, and the mixed group
    (odd shapes, zero columns, half-steps, negative zeros, denormals, a NaN
    column between other leaves), packed as the kernel takes them: int8
    values and scales bit for bit ``quantize_np`` (tolerance 0).  The NaN
    column's scale is NaN on both sides and its int8 values, an unspecified
    cast, are not compared; no other leaf or column is touched."""
    xs = _float_group(group)
    packed, layout = pack_quantize_group(xs, "cpu")
    values, scales = quantize_group_reference(packed, layout.table)
    for x, (_, soff, voff, r, c, _) in zip(xs, layout.table.tolist()):
        with np.errstate(invalid="ignore"):
            want_q, want_s = quantize_np(x)
        q, s = values[voff:voff + r * c].view(r, c).numpy(), scales[soff:soff + c].numpy()
        keep = ~np.isnan(x).any(axis=0)
        np.testing.assert_array_equal(q[:, keep], want_q[:, keep])
        np.testing.assert_array_equal(_bits(s[keep]), _bits(want_s[0, keep]))
        assert np.isnan(s[~keep]).all() and np.isnan(want_s[0, ~keep]).all()
    if group == "artifact":  # a fixed point: quantizing the dequantized leaves gives back the stored ones
        for (v, s), (q, sc) in zip(_artifact_int8_leaves(), quantize_group(xs, "cpu")):
            np.testing.assert_array_equal(q.numpy(), v)
            np.testing.assert_array_equal(sc.numpy()[0], s)


@pytest.mark.parametrize("kernel", ["dequantize", "quantize"])
def test_group_tables_align_separate_and_cover_every_leaf(kernel):
    """The shipped artifact's 137 leaves and the mixed group's shapes: every
    leaf's values start where the kernel needs them (16-aligned for
    dequantize, back to back for quantize) and do not overlap the next; the
    scales and the blocks follow one another; each leaf gets exactly the
    blocks that cover it."""
    shapes = [v.shape for v, _ in _artifact_int8_leaves()] + [v.shape for _, v, _ in chip_smoke.mixed_int8_group()]
    if kernel == "dequantize":
        layout = quantization.dequantize_layout(shapes + [(0, 7), (3, 5)])
        align, per_block = quantization.DEQUANTIZE_ALIGN, lambda r, c: r * c / quantization.DEQUANTIZE_BLOCK_VALUES
    else:
        layout = quantization.quantize_layout(shapes)
        align, per_block = 1, lambda r, c: c / quantization.QUANTIZE_BLOCK_COLS
    t = layout.table
    assert t.dtype == np.int64 and t.shape == (len(shapes) + (2 if kernel == "dequantize" else 0), 6)
    sizes = t[:, 3] * t[:, 4]
    assert (t[:, 0] % align == 0).all() and (t[:, 0] == t[:, 2]).all()
    assert t[0, 0] == 0 and (t[1:, 0] >= t[:-1, 0] + sizes[:-1]).all() and (t[1:, 0] - t[:-1, 0] - sizes[:-1] < align).all()
    assert layout.values == t[-1, 0] + sizes[-1]
    assert (t[:, 1] == np.concatenate([[0], np.cumsum(t[:-1, 4])])).all() and layout.scales == t[:, 4].sum()
    blocks = np.array([int(np.ceil(per_block(r, c))) for r, c in t[:, 3:5]])
    assert (t[:, 5] == np.concatenate([[0], np.cumsum(blocks[:-1])])).all() and layout.blocks == blocks.sum()
    artifact = quantization.dequantize_layout(shapes[:137]) if kernel == "dequantize" else \
        quantization.quantize_layout(shapes[:137])
    assert (artifact.values, artifact.scales) == (3_841_920, 55_020)  # no padding: every leaf is 16-aligned
    assert artifact.blocks == (989 if kernel == "dequantize" else 1736)


def test_restore_dequantizes_every_int8_leaf_as_one_group():
    """On the CPU the restore goes through the same packing and table: every
    int8 leaf comes back as a view of one buffer, no kernel is launched."""
    path = os.path.join(REPO, "trained", ARTIFACTS[0] + ".npz")
    LAUNCHES.reset()
    params, _, _ = torch_checkpoint.restore_checkpoint(path, device="cpu")
    assert LAUNCHES.snapshot() == {}
    with np.load(path) as data:
        names = [k[len("params/"):-len("/int8")] for k in data.files if k.endswith("/int8")]
    storages = set()
    for name in names:
        node = params
        for part in name.split("/"):
            node = node[int(part)] if isinstance(node, list) else node[part]
        storages.add(node.untyped_storage().data_ptr())
    assert len(names) == 137 and len(storages) == 1


@pytest.mark.parametrize("leaves", ["numpy", "tensor"])
def test_int8_save_of_the_artifact_has_the_jax_canonical_digest(tmp_path, leaves):
    """The shipped artifact restored by the JAX package and saved int8 by both
    packages (the port's large leaves as one group on the CPU): the same
    canonical digest (name, dtype, shape, C-ordered bytes of every member)."""
    jp, jb, _ = jax_checkpoint.restore_checkpoint(os.path.join(REPO, "trained", ARTIFACTS[0] + ".npz"))
    jp, jb = jax.tree.map(np.asarray, (jp, jb))
    jpath = jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), "w", jp, jb, backend="int8")
    given = (jp, jb) if leaves == "numpy" else jax.tree.map(lambda a: torch.from_numpy(np.array(a)), (jp, jb))
    LAUNCHES.reset()
    tpath = torch_checkpoint.save_checkpoint(str(tmp_path / "port"), "w", *given, backend="int8", device="cpu")
    assert LAUNCHES.get("quantize") == 0
    assert reference.content_digest(tpath) == reference.content_digest(jpath)


def test_group_wrappers_refuse_empty_groups_wrong_dtypes_and_other_devices():
    v, s = np.zeros((2, 3), np.int8), np.ones(3, np.float32)
    meta = torch.zeros((2, 3), dtype=torch.int8, device="meta")
    for bad in ([], [(v.astype(np.int16), s)], [(v, s.astype(np.float64))], [(v, s[:2])], [(v, s), (meta, s)]):
        with pytest.raises(ValueError):
            dequantize_group(bad, "cpu")
    x = torch.ones((2, 3), dtype=torch.float32)
    for bad in ([], [x.double()], [x[:, :0]], [x.reshape(-1)], [x, x.to("meta")]):
        with pytest.raises(ValueError):
            quantize_group(bad, "cpu")
