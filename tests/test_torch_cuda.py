"""The port's hand-written CUDA kernels against their plain versions, on the card.

Every test here is ``cuda``-marked and skips where there is no NVIDIA GPU.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; there, without ``tests/conftest.py`` (which
imports JAX):

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider -q

Bit equality is required: each kernel does its plain version's float
arithmetic in the same order.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
from hmd_ego_pose_tpu_torch.ops import distances, target_assign
from hmd_ego_pose_tpu_torch.ops.quantization import (dequantize, dequantize_group, dequantize_reference, quantize,
                                                     quantize_group, quantize_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def test_dequantize_kernel_bit_equal_to_plain_on_the_card(cuda_device):
    shapes = [(1, 1), (1, 300), (5, 33), (130, 97), (1152, 320)]
    LAUNCHES.reset()
    for i, (rows, cols) in enumerate(shapes):
        rng = np.random.default_rng(i)
        values = rng.integers(-127, 128, size=(rows, cols), dtype=np.int8)
        scales = rng.uniform(1e-5, 0.5, size=(cols,)).astype(np.float32)
        v, s = torch.from_numpy(values).to(cuda_device), torch.from_numpy(scales).to(cuda_device)
        got = dequantize(v, s)
        torch.cuda.synchronize()
        assert torch.equal(got, dequantize_reference(v, s))
    assert LAUNCHES.get("dequantize") == len(shapes)
    with pytest.raises(ValueError):
        dequantize(v.float(), s)


def test_min_distances_kernel_bit_equal_to_plain_on_the_card(cuda_device):
    shapes = [(1, 1, 1), (3, 700, 513), (2, 5000, 4999), (200, 600, 600)]
    rng = np.random.default_rng(0)
    LAUNCHES.reset()
    for t, p, q in shapes:
        g = rng.uniform(-60, 60, size=(t, p, 3)) + [0.0, 0.0, 550.0]
        pr = rng.uniform(-60, 60, size=(t, q, 3)) + [0.0, 0.0, 550.0]
        g[:, : min(p, q) // 3] = pr[:, : min(p, q) // 3]  # exact zeros
        g, pr = (torch.from_numpy(a.astype(np.float32)).to(cuda_device) for a in (g, pr))
        got = distances.min_distances(g, pr)
        torch.cuda.synchronize()
        assert torch.equal(got, distances.min_distances_reference(g, pr))
    assert LAUNCHES.get("min_distances") == len(shapes)
    with pytest.raises(ValueError):
        distances.min_distances(g.double(), pr)


def test_min_distances_kernel_bit_equal_at_the_smoke_shapes(cuda_device):
    """``chip_smoke.MIN_DIST_SHAPES``: the evaluation's shape, a single point,
    P off every slice, Q above one staged chunk (2048), the 1000-point cap;
    duplicate points; one launch per call; a NaN point makes its pair's rows NaN."""
    rng = np.random.default_rng(1)
    LAUNCHES.reset()
    for shape in chip_smoke.MIN_DIST_SHAPES:
        g, pr = (torch.from_numpy(a).to(cuda_device) for a in chip_smoke.point_pairs(rng, *shape))
        got = distances.min_distances(g, pr)
        torch.cuda.synchronize()
        assert torch.equal(got, distances.min_distances_reference(g, pr)), shape
    assert LAUNCHES.get("min_distances") == len(chip_smoke.MIN_DIST_SHAPES)
    pr[0, 3, 1] = float("nan")  # a NaN point: every row of its pair NaN, no other pair touched
    got = distances.min_distances(g, pr)
    assert bool(got[0].isnan().all()) and not bool(got[1:].isnan().any())


def test_target_assign_kernel_bit_equal_to_plain_on_the_card(cuda_device):
    """``chip_smoke.target_cases``: the train shape, K = 3 padded with two
    classes, the hazard batch, K = 4 with repeated best anchors, images without
    valid ground truth, anchors outside the image, more rows than one staged
    chunk: all five outputs bit-equal, one launch count per call."""
    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.ops.anchors import device_anchors

    cfg = ModelConfig()
    anchors = device_anchors(cfg.image_size, cfg.anchors, cuda_device)[0]
    cases = chip_smoke.target_cases(np.random.default_rng(0))
    LAUNCHES.reset()
    for name, (gt, num_classes, image_size) in cases.items():
        gt = [torch.from_numpy(x).to(cuda_device) for x in gt]
        kw = dict(num_classes=num_classes, image_size=image_size)
        got = target_assign.assign_targets_batch(anchors, *gt, **kw)
        torch.cuda.synchronize()
        want = target_assign.assign_targets_batch_reference(anchors, *gt, **kw)
        for field, a, b in zip(want._fields, got, want):
            assert chip_smoke.same_bits(a, b), (name, field)
    assert LAUNCHES.get("target_assign") == len(cases)


def test_target_assign_wrapper_raises_on_mixed_devices_and_wrong_dtypes(cuda_device):
    gt = [torch.from_numpy(x).to(cuda_device) for x in chip_smoke.target_batch(np.random.default_rng(0), 2, 3, 1)]
    anchors = torch.zeros((7, 4), device=cuda_device)
    kw = dict(num_classes=1, image_size=256)
    with pytest.raises(ValueError):
        target_assign.assign_targets_batch(anchors.cpu(), *gt, **kw)
    with pytest.raises(ValueError):
        target_assign.assign_targets_batch(anchors, gt[0], gt[1].long(), *gt[2:], **kw)
    with pytest.raises(ValueError):
        target_assign.assign_targets_batch(anchors, *gt[:4], gt[4].float(), **kw)
    with pytest.raises(ValueError):
        target_assign.assign_targets_batch(anchors, gt[0].transpose(1, 2).contiguous().transpose(1, 2), *gt[1:], **kw)


def test_quantize_kernel_bit_equal_to_plain_on_the_card(cuda_device):
    """The odd shapes (a single value and row, C off 32, the artifact's largest
    leaf and smallest C), zero columns, exact half-steps, negative zeros and
    denormals: int8 values and scales bit for bit; one launch per call."""
    cases = chip_smoke.quantize_inputs()
    LAUNCHES.reset()
    for name, x in cases.items():
        x = torch.from_numpy(x).to(cuda_device)
        q, s = quantize(x)
        torch.cuda.synchronize()
        want_q, want_s = quantize_reference(x)
        assert q.dtype == torch.int8 and s.shape == (1, x.shape[1]), name
        assert torch.equal(q, want_q), name
        assert torch.equal(s.view(torch.int32), want_s.view(torch.int32)), name
    assert LAUNCHES.get("quantize") == len(cases)
    with pytest.raises(ValueError):
        quantize(x.double())


def test_dequantize_group_bit_equal_to_plain_with_one_launch(cuda_device):
    """The mixed group (odd shapes, zero columns, half-steps, denormal and NaN
    scales) as one group: every leaf bit-equal to the plain version, one launch;
    a group of one equals ``dequantize``."""
    leaves = [(v, s) for _, v, s in chip_smoke.mixed_int8_group()]
    LAUNCHES.reset()
    got = dequantize_group(leaves, cuda_device)
    torch.cuda.synchronize()
    assert LAUNCHES.get("dequantize") == 1
    for (v, s), g in zip(leaves, got):
        want = dequantize_reference(torch.from_numpy(v).to(cuda_device), torch.from_numpy(s).to(cuda_device))
        assert chip_smoke.same_bits(g, want), v.shape
    v, s = leaves[4]
    one = dequantize_group([(v, s)], cuda_device)[0]
    assert torch.equal(one, dequantize(torch.from_numpy(v).to(cuda_device), torch.from_numpy(s).to(cuda_device)))


def test_quantize_group_bit_equal_to_plain_with_one_launch(cuda_device):
    """The mixed group (odd shapes, zero columns, half-steps, negative zeros,
    denormals, a NaN column between other leaves) as one group: int8 values
    and scales bit-equal to the plain version, the NaN column's scale NaN on
    both and no other leaf touched, one launch; a group of one equals ``quantize``."""
    cases = {name: torch.from_numpy(x).to(cuda_device) for name, x in chip_smoke.mixed_float_group().items()}
    LAUNCHES.reset()
    got = quantize_group(list(cases.values()))
    torch.cuda.synchronize()
    assert LAUNCHES.get("quantize") == 1
    for (name, x), (q, s) in zip(cases.items(), got):
        want_q, want_s = quantize_reference(x)
        assert q.shape == x.shape and s.shape == (1, x.shape[1]), name
        keep = torch.arange(x.shape[1], device=cuda_device) != (4 if name == "nan_column" else -1)
        assert torch.equal(q[:, keep], want_q[:, keep]), name
        assert chip_smoke.same_bits(s[:, keep], want_s[:, keep]), name
        if name == "nan_column":
            assert bool(s[0, 4].isnan()) and bool(want_s[0, 4].isnan())
    x = cases["5x33"]
    (q1, s1), (q, s) = quantize_group([x])[0], quantize(x)
    assert torch.equal(q1, q) and chip_smoke.same_bits(s1, s)


def test_group_wrappers_raise_on_mixed_devices_wrong_dtypes_and_empty_groups(cuda_device):
    v = np.zeros((2, 3), np.int8)
    s = np.ones(3, np.float32)
    on_card = (torch.from_numpy(v).to(cuda_device), torch.from_numpy(s).to(cuda_device))
    for bad in ([(v, s), on_card], [(v.astype(np.int16), s)], [(v, s.astype(np.float64))], []):
        with pytest.raises(ValueError):
            dequantize_group(bad, cuda_device)
    x = torch.ones((2, 3), dtype=torch.float32)
    for bad in ([x, x.to(cuda_device)], [x.double().to(cuda_device)], [x.to(cuda_device)[:, :0]], []):
        with pytest.raises(ValueError):
            quantize_group(bad, cuda_device)
    with pytest.raises(ValueError):
        dequantize(on_card[0], on_card[1].cpu())


def test_pack_transfer_on_the_card_equals_per_leaf_uploads(cuda_device):
    from hmd_ego_pose_tpu_torch.utils.device import UPLOADS, pack_transfer

    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": [np.asfortranarray(rng.normal(size=(4, 2, 3)).astype(np.float32)), np.int64(9)],
            "c": (np.zeros((0,), np.float32), rng.integers(0, 9, size=(7,), dtype=np.int64))}
    UPLOADS.reset()
    got = pack_transfer(tree, cuda_device)
    assert UPLOADS.snapshot() == {"pack_transfer/float32": 1, "pack_transfer/int64": 1}
    pairs = [(got["a"], tree["a"]), (got["b"][0], tree["b"][0]), (got["b"][1], tree["b"][1]),
             (got["c"][0], tree["c"][0]), (got["c"][1], tree["c"][1])]
    for g, w in pairs:
        one = torch.as_tensor(np.array(np.asarray(w), order="C")).to(cuda_device)
        assert g.device.type == "cuda" and g.dtype == one.dtype and g.shape == one.shape
        assert torch.equal(g, one)


def test_packed_restore_on_the_card_equals_the_cpu_restore(cuda_device):
    """The shipped artifact: one float32 copy and the int8 group's three (values,
    scales, table), one dequantize launch, every leaf bit-equal to the CPU restore."""
    from hmd_ego_pose_tpu_torch.train.checkpoint import _flatten, restore_checkpoint
    from hmd_ego_pose_tpu_torch.utils.device import UPLOADS

    UPLOADS.reset()
    LAUNCHES.reset()
    on_card = restore_checkpoint(chip_smoke.ARTIFACT, cuda_device)
    torch.cuda.synchronize()
    assert UPLOADS.snapshot() == {"pack_transfer/float32": 1, "dequantize_group/values": 1,
                                  "dequantize_group/scales": 1, "dequantize/table": 1}
    assert LAUNCHES.snapshot() == {"dequantize": 1}
    on_cpu = restore_checkpoint(chip_smoke.ARTIFACT, "cpu")
    assert on_card[2] == on_cpu[2]
    got, want = _flatten(on_card[:2]), _flatten(on_cpu[:2])
    assert list(got) == list(want) and len(got) == 452 + 137 + 306
    for name in want:
        assert got[name].device.type == "cuda" and chip_smoke.same_bits(got[name].cpu(), want[name]), name


def test_kernels_launch_on_the_tensors_card_not_the_current_one(cuda_device):
    """Tensors on cuda:1 while the current device is cuda:0 (a data-parallel
    rank's case): each kernel launches on cuda:1 and equals its plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    rng = np.random.default_rng(3)
    LAUNCHES.reset()
    values = torch.from_numpy(rng.integers(-127, 128, size=(33, 17), dtype=np.int8)).to(dev)
    scales = torch.from_numpy(rng.uniform(1e-5, 0.5, size=(17,)).astype(np.float32)).to(dev)
    assert torch.equal(dequantize(values, scales), dequantize_reference(values, scales))
    g, pr = (torch.from_numpy(rng.uniform(-60, 60, size=(3, n, 3)).astype(np.float32)).to(dev) for n in (70, 50))
    assert torch.equal(distances.min_distances(g, pr), distances.min_distances_reference(g, pr))
    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.ops.anchors import device_anchors

    anchors = device_anchors(256, ModelConfig().anchors, dev)[0]
    gt = [torch.from_numpy(x).to(dev) for x in chip_smoke.target_batch(rng, 8, 1, 1)]
    got = target_assign.assign_targets_batch(anchors, *gt, num_classes=1, image_size=256)
    want = target_assign.assign_targets_batch_reference(anchors, *gt, num_classes=1, image_size=256)
    torch.cuda.synchronize(dev)
    assert all(chip_smoke.same_bits(a, b) for a, b in zip(got, want))
    assert torch.cuda.current_device() == 0
    assert LAUNCHES.snapshot() == {"dequantize": 1, "min_distances": 1, "target_assign": 1}


def test_two_gloo_ranks_share_the_card(cuda_device, tmp_path):
    """Two data-parallel ranks on the one card over gloo (as chip_smoke.py's
    train_dp phase runs them): the cross-replica BN equals the single-process
    BN of the whole batch on the card, and one fixed train step (phi-0, 128 px,
    global batch 4) leaves both ranks bit-identical, its losses within 1e-5 of
    the single-process step's."""
    import os
    import subprocess
    import sys

    import torch_dp_ranks

    from hmd_ego_pose_tpu_torch.parallel.mesh import LOCAL

    data = str(tmp_path / "syn")
    subprocess.run([sys.executable, "-m", "hmd_ego_pose_tpu_torch.cli", "make-synthetic", "--out-dir", data,
                    "--num-frames", "8", "--frame-size", "128", "--hand-render-version", "3"],
                   check=True, cwd=torch_dp_ranks.REPO, timeout=120)
    step = {"kind": "steps", "dataset": data, "size": 128, "batch": 4, "steps": 1}
    ranks = torch_dp_ranks.run_ranks(2, [{"kind": "bn"}, step], tmp_path, device="cuda")
    single_bn = torch_dp_ranks.bn_job({"kind": "bn"}, LOCAL, "cuda")
    for update_stats in (True, False):
        y = np.concatenate([r[0][update_stats]["y"] for r in ranks])
        np.testing.assert_allclose(y, single_bn[update_stats]["y"], rtol=1e-6, atol=1e-6)
        for key in ("running_mean", "running_var"):
            np.testing.assert_array_equal(ranks[0][0][update_stats][key], ranks[1][0][update_stats][key])
            np.testing.assert_allclose(ranks[0][0][update_stats][key], single_bn[update_stats][key], rtol=1e-6)
    single = torch_dp_ranks.steps_job(step, os.path.join(str(tmp_path), "single"), "cuda")
    assert ranks[0][1]["digests"] == ranks[1][1]["digests"]
    for term, v in single["steps"][0].items():
        assert ranks[0][1]["steps"][0][term] == pytest.approx(v, rel=1e-5), term


def test_cli_parity_and_iter1_evaluation_on_the_card_equal_the_cpus(cuda_device, tmp_path):
    """``cli parity`` of the artifact's state_dict and ``cli evaluate --iter 1
    --save-images-path`` of the seeded iter-1 checkpoint on a 12-frame v3 set,
    at 128 px, on the card against the same commands with ``--device cpu``:
    parity values within ``chip_smoke.PARITY_TOLERANCE_REL`` at the layer's
    scale; every evaluation scalar within ``chip_smoke.EVAL_TOLERANCES``; the
    same image files."""
    import os

    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.models.weights import from_jax_params

    data = str(tmp_path / "v3")
    cli.main(["make-synthetic", "--out-dir", data, "--num-frames", "12", "--frame-size", "128",
              "--hand-render-version", "3"])
    ckpt, params, bn_state = chip_smoke.write_iter1_checkpoint(str(tmp_path), "cpu")
    pth = str(tmp_path / "artifact.pth")
    torch.save({"module." + k: v for k, v in from_jax_params(params, bn_state, ModelConfig()).items()}, pth)
    parity = {d: cli.main(["parity", "--torch-ckpt", pth, "--img-size", "128", "--device", d]) for d in ("cuda", "cpu")}
    chip_smoke.hold_parity(parity["cuda"], parity["cpu"])
    results = {}
    for d in ("cuda", "cpu"):
        LAUNCHES.reset()
        results[d] = cli.main(["evaluate", "--dataset-path", data, "--ckpt", ckpt, "--partition", "train", "--iter", "1",
                               "--img-size", "128", "--save-images-path", str(tmp_path / d), "--device", d]).scalars()
        assert LAUNCHES.snapshot() == ({"dequantize": 1, "min_distances": 1} if d == "cuda" else {})
    for name, want in results["cpu"].items():
        assert abs(results["cuda"][name] - want) <= chip_smoke.EVAL_TOLERANCES[chip_smoke.scalar_kind(name)], name
    assert sorted(os.listdir(tmp_path / "cuda")) == sorted(os.listdir(tmp_path / "cpu"))
