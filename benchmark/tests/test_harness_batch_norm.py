"""``batch_norm_roofline``: the training norms' bytes from the reference's
shapes, and the reader on a hand-made trace."""

import pytest

from harness import arith, common
from harness.trace import Trace

READER = common.metric_reader("batch_norm_roofline")


def test_the_reference_has_the_programs_153_norms():
    import torch

    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose, apply_train
    from hmd_ego_pose_tpu_torch.nn.core import BatchNorm

    sites = READER.norm_sites(128)
    assert len(sites) == 153
    assert sum(name.startswith("backbone/") for name, _ in sites) == 48
    assert sum(name.startswith("bifpn/") for name, _ in sites) == 30
    model = HMDEgoPose(ModelConfig(image_size=128))
    seen = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(lambda mod, args, out: seen.append(args[0][0].numel()))
    with torch.no_grad():
        apply_train(model, torch.zeros((1, 128, 128, 3)), model.config)
    assert sorted(seen) == sorted(values for _, values in sites)


def test_bytes_count_each_input_and_output_once():
    sites = READER.norm_sites(256)
    forward = sum(values for _, values in sites)
    trained = sum(values for name, values in sites if not name.startswith("backbone/"))
    assert READER.norm_bytes(256, 16, True) == 4.0 * 16 * (2 * forward + 3 * trained)
    assert READER.norm_bytes(256, 16, False) == 4.0 * 16 * 5 * forward
    assert READER.norm_bytes(512, 16, True) == pytest.approx(4 * READER.norm_bytes(256, 16, True), rel=0.01)


def test_the_share_reads_the_kernels_by_name_and_nothing_without_them():
    ms = 1_000_000
    device = [(0, 2 * ms, "void (anonymous namespace)::bn_stats_partial_kernel<4>(float const*)"),
              (2 * ms, 3 * ms, "void (anonymous namespace)::bn_apply_kernel<4, true>(float const*)"),
              (3 * ms, 4 * ms, "void (anonymous namespace)::bn_grad_apply_kernel<1, false>(float const*)"),
              (4 * ms, 9 * ms, "batch_norm_collect_statistics_kernel"), (9 * ms, 10 * ms, "elementwise_kernel")]
    ctx = {"trace": Trace(device, [], 0, 10 * ms), "slice_steps": 3, "image_size": 128, "batch_size": 16,
           "freeze_backbone": True}
    least = arith.bound_seconds(READER.norm_bytes(128, 16, True), 0.0)
    assert READER.read(ctx) == pytest.approx(100 * 3 * least / 0.004)
    ctx["trace"] = Trace(device[3:], [], 0, 10 * ms)
    assert READER.read(ctx) is None
    assert READER.read({}) is None
