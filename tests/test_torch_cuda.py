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


def test_space_two_forward_on_the_card_equals_the_single_process_forward(cuda_device, tmp_path):
    """Two ranks of a space-2 mesh sharing the card over gloo (as chip_smoke.py's
    spatial phase runs them): the forward of the artifact's weights (phi-0,
    128 px, fp32) on the two slabs of a seeded image equals the single-process
    forward on the card within the JAX spatial test's rtol 2e-4, atol 2e-5."""
    import torch_dp_ranks

    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.train.checkpoint import load_model

    model, _ = load_model(torch_dp_ranks.ARTIFACT, ModelConfig(phi=0, image_size=128, compute_dtype="float32"),
                          device="cpu")
    state = str(tmp_path / "artifact.pt")
    torch.save(model.state_dict(), state)
    job = {"kind": "spatial", "what": "forward", "layout": [1, 1, 2], "batch": 1, "seed": 0, "state": state}
    ranks = torch_dp_ranks.run_ranks(2, [job], tmp_path, device="cuda")
    single = torch_dp_ranks.spatial_job(job, "cuda")
    for r in ranks:
        assert r[0]["collectives"]["halo"] > 0 and r[0]["collectives"]["gather"] > 0
        for key, want in single["outputs"].items():
            np.testing.assert_allclose(r[0]["outputs"][key], want, rtol=2e-4, atol=2e-5, err_msg=key)


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


# ---------------------------------------------------------------------------
# CUDA graphs (utils/graphs.py): the engine's, the resident step's, evaluation's
# ---------------------------------------------------------------------------


def _to_host(det):
    torch.cuda.synchronize()
    return [t.cpu() for t in det]


def test_engine_graphs_equal_eager_with_two_batches_in_flight(cuda_device):
    """The engine's warmup captures one graph per batch size (phi-0, 256 px,
    bf16 as served, seeded weights); each replay equals the eager ``_predict``
    of the same frames bit for bit; two batches of one size in flight keep
    their own answers; a size without a graph runs eagerly and counts."""
    from hmd_ego_pose_tpu_torch.config import ModelConfig, ServingConfig
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose, init_weights
    from hmd_ego_pose_tpu_torch.serving.engine import InferenceEngine

    cfg = ModelConfig(phi=0, image_size=256, compute_dtype="bfloat16")
    model = init_weights(HMDEgoPose(cfg), torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, cfg, ServingConfig(max_batch_size=4, score_threshold=0.0),
                             frame_shape=(256, 256), device=cuda_device)
    engine.warmup()
    assert sorted(engine.graphs) == engine.batch_sizes == [1, 2, 4]
    assert engine.capture_s > 0 and engine.graph_pool_bytes > 0
    rng = np.random.default_rng(5)

    def eager(frames, cams):
        return _to_host(engine._predict(torch.from_numpy(frames).to(cuda_device), torch.from_numpy(cams).to(cuda_device)))

    for b in engine.batch_sizes:
        frames = rng.integers(0, 256, size=(b, 256, 256, 3), dtype=np.uint8)
        cams = np.tile(engine._default_camera()[None], (b, 1))
        got = _to_host(engine._dispatch_device(frames, cams))
        assert all(torch.equal(g, w) for g, w in zip(got, eager(frames, cams))), b
    a, b = (rng.integers(0, 256, size=(2, 256, 256, 3), dtype=np.uint8) for _ in range(2))
    cams = np.tile(engine._default_camera()[None], (2, 1))
    first = engine._dispatch_device(a, cams)
    second = engine._dispatch_device(b, cams)  # the same graph replays before the first batch is read
    for got, frames in ((first, a), (second, b)):
        assert all(torch.equal(g, w) for g, w in zip(_to_host(got), eager(frames, cams)))
    assert engine.eager_batches == 0
    engine._dispatch_device(np.concatenate([a, b[:1]]), np.tile(engine._default_camera()[None], (3, 1)))
    assert engine.eager_batches == 1


def test_resident_step_graph_equals_eager_and_launches_target_assign_per_replay(cuda_device, tmp_path):
    """Two trainers from one seed on an 8-frame 128 px set, augmentation and
    drop-connect on: three steps of ``ResidentGraph`` (warm-up, capture, two
    replays; the colour ops in fixed shapes inside the graph) against three
    eager steps (colour ops grouped by op) with the same draws and masks: the
    losses and every parameter and BN buffer bit-equal; ``target_assign``
    launched once a step; Adam's count on the card.  With deterministic
    cuDNN: some of its default weight-gradient algorithms accumulate with
    atomics, so an eager step need not repeat its own bits."""
    from hmd_ego_pose_tpu_torch import cli
    from hmd_ego_pose_tpu_torch.config import Config, ModelConfig, TrainConfig
    from hmd_ego_pose_tpu_torch.data.colibri import ColibriDataset
    from hmd_ego_pose_tpu_torch.ops.augment_device import draw_augment
    from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES
    from hmd_ego_pose_tpu_torch.train.trainer import Trainer
    from hmd_ego_pose_tpu_torch.utils.logging import MetricLogger

    data = str(tmp_path / "syn")
    cli.main(["make-synthetic", "--out-dir", data, "--num-frames", "8", "--frame-size", "128",
              "--hand-render-version", "3"])
    cfg = Config(model=ModelConfig(image_size=128),
                 train=TrainConfig(batch_size=2, oversample=1, seed=3, checkpoint_dir=str(tmp_path / "ckpt")))
    eager, graphed = (Trainer(cfg, ColibriDataset(data, 0, 1, "train"), None, device=cuda_device,
                              logger=MetricLogger(stdout=False)) for _ in range(2))
    assert graphed.graphed and graphed.graph.steps == 3
    ge, gg = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    rows = [torch.tensor([0, 1]), torch.tensor([2, 0]), torch.tensor([1, 2])]
    want = []
    torch.backends.cudnn.deterministic = True
    try:
        for idx in rows:
            metrics = eager.step_fn(eager.data, idx.to(cuda_device), draw_augment(ge, 2, 128, 128), ge)
            want.append(torch.stack([metrics[k] for k in METRIC_NAMES]))
        LAUNCHES.reset()
        for idx in rows:
            graphed.graph(idx, draw_augment(gg, 2, 128, 128), gg)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    assert LAUNCHES.snapshot() == {"target_assign": len(rows)}
    assert graphed.graph.colour is not None  # the colour ops ran inside the graph
    assert torch.equal(graphed.graph.metrics, torch.stack(want))
    se, sg = eager.model.state_dict(), graphed.model.state_dict()
    assert all(torch.equal(se[k], sg[k]) for k in se)
    assert graphed.optimizer.count == len(rows)
    steps = [s["step"] for s in graphed.optimizer.opt.state.values()]
    assert all(s.device.type == "cuda" and float(s) == len(rows) for s in steps)


@pytest.mark.parametrize("num_classes", [1, 2])
def test_eval_graph_equals_the_eager_predict(cuda_device, num_classes):
    """``make_eval_forward`` on the card (phi-0, 256 px, fp32, seeded weights,
    every score kept): one capture at ``eval_batch_size``; three batches
    replayed, each bit-equal to the eager predict in all six fields; a
    parameter replaced by a new tensor makes a second capture whose replay is
    the eager predict of the changed model."""
    from hmd_ego_pose_tpu_torch.config import Config, EvalConfig, ModelConfig
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose, init_weights
    from hmd_ego_pose_tpu_torch.train.step import EvalForward, make_eval_forward

    cfg = Config(model=ModelConfig(phi=0, image_size=256, num_classes=num_classes),
                 eval=EvalConfig(score_threshold=0.0))
    model = init_weights(HMDEgoPose(cfg.model), torch.Generator().manual_seed(0)).to(cuda_device)
    forward = make_eval_forward(model, cfg, cuda_device)
    assert isinstance(forward, EvalForward)
    rng = np.random.default_rng(num_classes)
    b = cfg.eval.eval_batch_size
    cams = np.tile(np.array([480, 480, 128, 128, 1000, 1], np.float32), (b, 1))

    def held(images):
        got, want = forward(images, cams), forward.eager(images, cams)
        for f in got._fields:
            assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f
        return got

    for _ in range(3):
        got = held(rng.normal(size=(b, 256, 256, 3)).astype(np.float32))
    assert forward.captures == 1 and (got.scores > 0).any()
    if num_classes == 2:
        assert set(np.unique(got.labels)) >= {0, 1}
    conv = model.classifier.header.pointwise_conv.conv
    conv.bias = torch.nn.Parameter(conv.bias.detach() + 0.5)
    held(rng.normal(size=(b, 256, 256, 3)).astype(np.float32))
    assert forward.captures == 2


@pytest.mark.parametrize("h,w", chip_smoke.COLOUR_SIZES)
def test_color_augment_fixed_equals_grouped_on_the_card(cuda_device, h, w):
    """The fixed-shape colour pass (the resident step graph's) against
    ``color_augment_batch`` on the card, bit for bit per row, on draws with
    every op, noise in both slots, an inactive slot and an example not
    augmented (``chip_smoke.colour_cases``)."""
    from hmd_ego_pose_tpu_torch.ops import augment_device as aug

    frames, draws = chip_smoke.colour_cases(h, w)
    x = frames.to(cuda_device)
    fixed = aug.slot_draws(draws, h, w, cuda_device)
    assert torch.equal(aug.color_augment_fixed(x, fixed), aug.color_augment_batch(x, draws))


def test_a_failed_capture_raises(cuda_device):
    """A host read inside the captured function: the capture raises, it does not run eagerly."""
    from hmd_ego_pose_tpu_torch.utils import graphs

    x = torch.ones(4, device=cuda_device)
    with pytest.raises(RuntimeError):
        graphs.capture(lambda: (x * 2).sum().item(), cuda_device)
    torch.cuda.synchronize()
    assert float((x * 2).sum()) == 8.0  # the card still works


def test_nccl_collectives_captured_on_one_rank_and_counted_per_replay(cuda_device, monkeypatch):
    """A one-rank NCCL group (``parallel/distributed.py::initialize``) and the
    probe mesh of ``chip_smoke.py``, which makes every collective at one
    rank: BN's packed all-reduce mean and its backward, the gradients' packed
    mean, an all-gather and a broadcast captured through
    ``utils/graphs.capture`` and replayed.  NCCL moves no data at one rank,
    so a replay equals the eager call bit for bit; each replay counts its
    collectives by kind, with no host seconds."""
    import socket

    import torch.distributed as dist

    from hmd_ego_pose_tpu_torch.parallel import distributed
    from hmd_ego_pose_tpu_torch.utils import graphs

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, value in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1", RANK="0",
                           LOCAL_RANK="0").items():
        monkeypatch.setenv(key, value)
    assert distributed.initialize(cuda_device)
    try:
        mesh = chip_smoke.probe_mesh(torch.device("cuda", torch.cuda.current_device()))
        assert dist.get_backend() == "nccl" and mesh.capturable
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(4, 3, generator=gen).to(mesh.device).requires_grad_(True)
        grad = torch.randn(5, generator=gen).to(mesh.device)
        row = torch.randn(2, 7, generator=gen).to(mesh.device)
        frames = torch.randint(0, 255, (2, 8, 8, 3), generator=gen, dtype=torch.uint8).to(mesh.device)

        def body():
            mean, mean_sq = mesh.all_reduce_mean([x.mean(dim=0), (x * x).mean(dim=0)], "bn")
            (dx,) = torch.autograd.grad((mean * mean_sq).sum(), x)
            g = grad * 3
            mesh.mean_([g], "grads", "batch")
            f = frames + 1
            mesh.broadcast_(f, "engine")
            return mean, mean_sq, dx, g, torch.cat(mesh.all_gather(row * 2, "engine", "data")), f

        # detached: an eager autograd graph kept alive would keep x's gradient
        # accumulator on the default stream, which a captured backward must not wait on
        want = [t.detach().clone() for t in body()]
        graph = graphs.capture(body, mesh.device)
        assert sorted(kind for _, kind in graph.collectives) == ["bn", "bn_backward", "engine", "engine", "grads"]
        mesh.stats.reset()
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        for got, w in zip(graph.outputs, want):
            assert torch.equal(got, w)
        assert mesh.stats.calls == {"bn": 3, "bn_backward": 3, "grads": 3, "engine": 6}
        assert dict(mesh.stats.seconds) == {}
    finally:
        dist.destroy_process_group()


def test_space_probe_halos_and_gathers_captured_and_counted_per_replay(cuda_device, monkeypatch):
    """The space probe of ``chip_smoke.py`` (``probe_space_mesh``: space rank 0
    of two, the other mirrored) on a one-rank NCCL group:
    ``parallel/spatial.py::halo`` within a slab and deeper than one, and
    ``gather_rows``, forward and backward, captured through
    ``utils/graphs.capture`` and replayed.  Each replay equals the eager call
    bit for bit and counts its collectives once, with no host seconds."""
    import socket

    import torch.distributed as dist

    from hmd_ego_pose_tpu_torch.parallel import distributed, spatial
    from hmd_ego_pose_tpu_torch.utils import graphs

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, value in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1", RANK="0",
                           LOCAL_RANK="0").items():
        monkeypatch.setenv(key, value)
    assert distributed.initialize(cuda_device)
    try:
        mesh = chip_smoke.probe_space_mesh(torch.device("cuda", torch.cuda.current_device()))
        assert dist.get_backend() == "nccl" and mesh.capturable and mesh.space == 2
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(2, 3, 4, 5, generator=gen).to(mesh.device).requires_grad_(True)
        weights = [torch.randn(shape, generator=gen).to(mesh.device)
                   for shape in ((2, 3, 7, 5), (2, 3, 12, 5), (2, 3, 8, 5))]

        def body():
            shallow = spatial.halo(x, mesh, 1, 2)  # within the slab of 4 rows
            deep = spatial.halo(x, mesh, 5, 3)  # deeper than the slab: the whole level gathered
            whole = spatial.gather_rows(x, mesh)
            loss = sum((t * w).sum() for t, w in zip((shallow, deep, whole), weights))
            (dx,) = torch.autograd.grad(loss, x)
            return shallow.detach(), deep.detach(), whole.detach(), dx

        want = [t.clone() for t in body()]
        graph = graphs.capture(body, mesh.device)
        assert sorted(kind for _, kind in graph.collectives) == sorted(
            ["halo", "halo", "gather", "halo_backward", "halo_backward", "gather_backward"])
        mesh.stats.reset()
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        for got, w in zip(graph.outputs, want):
            assert torch.equal(got, w)
        assert mesh.stats.calls == {"halo": 6, "gather": 3, "halo_backward": 6, "gather_backward": 3}
        assert dict(mesh.stats.seconds) == {}
    finally:
        dist.destroy_process_group()
