"""The metric arithmetic on a hand-made trace and on known shapes."""

import statistics

import pytest

from harness import arith, common
from harness.trace import Trace
from reference.model import Widths

PHI0 = Widths.of(common.cell("train-phi0-256-b16")["config"])


def _trace():
    ms = 1_000_000
    device = [(0, 2 * ms, "k_a"), (1 * ms, 3 * ms, "k_b"), (5 * ms, 6 * ms, "k_a"), (8 * ms, 8.5 * ms, "best_anchor_kernel(float const*)"), (8.5 * ms, 9 * ms, "void assign_kernel<1>(x)")]
    host = [(3 * ms, 5 * ms, "cudaGraphLaunch"), (6 * ms, 7 * ms, "cudaLaunchKernel"),
            (7 * ms, 8 * ms, "cudaLaunchKernel"), (0, 1 * ms, "aten::copy_")]
    return Trace(device, host, 0, 10 * ms)


def test_busy_idle_and_launches_of_a_hand_made_trace():
    t = _trace()
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.005)  # [0, 3] + [5, 6] + [8, 9] ms
    assert t.launch_calls() == 3
    assert t.device_seconds(lambda n: "kernel" in n) == pytest.approx(0.001)
    assert t.device_ops(2) == [["k_a", pytest.approx(0.003)], ["k_b", pytest.approx(0.002)]]
    gaps = t.idle_gaps()
    assert gaps[0] == ["cudaGraphLaunch", pytest.approx(0.002)]
    assert [g[1] for g in gaps] == pytest.approx([0.002, 0.002, 0.001])
    assert gaps[1][0] == "cudaLaunchKernel"


def test_device_intervals_outside_the_slice_are_cut():
    t = Trace([(-5, 5, "k"), (8, 20, "k")], [], 0, 10)
    assert t.busy_s == pytest.approx(7e-9)


def test_percentiles_count_a_missing_answer_as_last():
    assert arith.percentile([1, 2, 3, 4], 50) == pytest.approx(2.5)
    assert arith.percentile([1.0] * 19 + [float("inf")], 95) == float("inf")
    assert arith.percentile([1.0] * 99 + [float("inf")], 50) == 1.0
    values = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert arith.spread(values) == pytest.approx((q3 - q1) / med)


def test_target_assign_work_is_the_programs_formula():
    from hmd_ego_pose_tpu_torch.kernels.bounds import target_assign_work

    for n, b in ((12276, 16), (49104, 16), (12276, 8)):
        assert arith.target_assign_work(n, 1, b, 1) == target_assign_work(n, 1, b, 1)
    moved, ops = arith.target_assign_work(12276, 1, 16, 1)
    assert arith.bound_seconds(moved, ops) == pytest.approx(moved / 3.35e12)  # bytes bound it


def test_anchor_counts():
    assert arith.num_anchors(256) == 12276
    assert arith.num_anchors(512) == 49104


def test_eval_flops_match_the_programs_counter_on_its_own_model():
    import torch

    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
    from hmd_ego_pose_tpu_torch.utils.model_stats import forward_flops

    program = forward_flops(HMDEgoPose(ModelConfig(image_size=128)).to("meta"), 128)
    assert arith.model_flops(PHI0, 128, False) == pytest.approx(program, rel=1e-6)
    # a frozen backbone's backward adds the BiFPN's and the heads' gradients only
    backbone = arith.forward_flops(PHI0, 128, "backbone")
    assert 0 < backbone < program
    assert arith.model_flops(PHI0, 128, True) == pytest.approx(3 * program - 2 * backbone)
    assert arith.model_flops(PHI0, 128, True, freeze_backbone=False) == pytest.approx(3 * program)


def test_shares_and_mfu_readers():
    ctx = {"trace": _trace(), "slice_steps": 2, "widths": PHI0, "image_size": 128, "batch_size": 16,
           "window_images": 320, "window_seconds": 2.0, "freeze_backbone": True, "window_peak_bytes": 2e9,
           "slice_frames": 4}
    assert common.metric_reader("launch_calls_per_step.train").read(ctx) == pytest.approx(1.5)
    assert common.metric_reader("device_idle_pct.train").read(ctx) == pytest.approx(50.0)
    assert common.metric_reader("peak_mem_gb.train").read(ctx) == pytest.approx(2.0)
    mfu = common.metric_reader("step_mfu.train").read(ctx)
    assert mfu == pytest.approx(100 * 320 * arith.model_flops(PHI0, 128, True) / 2.0 / 67e12)
    moved, ops = arith.target_assign_work(arith.num_anchors(128), 1, 16, 1)
    roof = common.metric_reader("target_assign_roofline").read(ctx)
    assert roof == pytest.approx(100 * 2 * arith.bound_seconds(moved, ops) / 0.001)
    serve = common.metric_reader("step_mfu.serve").read(ctx)
    assert serve == pytest.approx(100 * 4 * arith.model_flops(PHI0, 128, False) / 989e12 / 0.005)
    assert common.metric_reader("step_mfu.serve").read({"trace": None}) is None
