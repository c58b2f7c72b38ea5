"""The reference network at a configuration's widths.

At phi 0 the tree, the weight draw, the work counts and the outputs are
held to ``golden_phi0.json``, recorded from the reference as it stood
before it read its widths from the configuration (when it was fixed to
phi 0): the weights of a seed hashed, the counts exact, the outputs at 128
px on weights drawn from a seed (32 values at fixed places of each output,
and its sums).  At phi 3 the tree, the eval forward, the FLOPs and the
norms are held to the program's own model on the CPU.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from harness import arith, common
from reference import shapes
from reference.model import Net, Widths

BN = common.metric_reader("batch_norm_roofline")
GOLDEN = common.load_json(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_phi0.json"))
PHI3 = {"phi": 3, "backbone": "efficientnet-b3", "fpn_num_filters": 160, "fpn_cell_repeats": 6, "head_repeats": 4}
OUTPUTS = ("regression", "classification", "rotation", "translation_raw", "hand")


def _conf(name="hmdegopose-phi0-256", **changes):
    conf = common.load_json(os.path.join(common.BENCH, "configs", name + ".json"))
    conf.update(changes)
    return conf


def _sha(lines):
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


PHI0 = Widths.of(_conf())


def test_both_phi0_configurations_give_the_phi0_widths():
    assert Widths.of(_conf("hmdegopose-phi0-512")) == PHI0
    assert PHI0 == Widths("efficientnet-b0", 64, 3, 3)
    assert len(PHI0.blocks()) == 16 and PHI0.features() == (40, 112, 320) and PHI0.stem == 32


def test_phi0_tree_and_draw_are_the_parents():
    tree = shapes.param_shapes(PHI0)
    assert len(tree) == GOLDEN["param_count"]
    assert _sha([f"{k}:{','.join(map(str, v))}" for k, v in tree.items()]) == GOLDEN["param_shapes_sha256"]
    assert _sha([f"{k}:{v}" for k, v in shapes.stat_names(PHI0).items()]) == GOLDEN["stat_names_sha256"]
    params, stats = shapes.draw(torch.Generator().manual_seed(GOLDEN["seed"]), "cpu", PHI0)
    h = hashlib.sha256()
    for name in tree:
        h.update(name.encode())
        h.update(params[name].contiguous().numpy().astype(np.float32).tobytes())
    for name in sorted(stats):
        h.update(name.encode())
        h.update(stats[name].numpy().astype(np.float32).tobytes())
    assert h.hexdigest() == GOLDEN["draw_sha256"]


@pytest.mark.parametrize("size", [256, 512])
def test_phi0_work_counts_are_the_parents(size):
    flops, key = GOLDEN["forward_flops"][str(size)], str(size)
    assert arith.forward_flops(PHI0, size) == flops["network"]
    assert arith.forward_flops(PHI0, size, "backbone") == flops["backbone"]
    assert arith.model_flops(PHI0, size, False) == GOLDEN["model_flops"][key]["eval"]
    assert arith.model_flops(PHI0, size, True) == GOLDEN["model_flops"][key]["train"]
    sites, golden = BN.norm_sites(PHI0, size), GOLDEN["norm_sites"][key]
    assert len(sites) == golden["count"] == 153
    assert sum(v for _, v in sites) == golden["values"]
    assert _sha([f"{n}:{v}" for n, v in sites]) == golden["sha256"]
    assert BN.norm_bytes(PHI0, size, 16, True) == golden["bytes_b16_frozen"]


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_phi0_forwards_are_the_parents(mode):
    seed = GOLDEN["seed"]
    params, stats = shapes.draw(torch.Generator().manual_seed(seed), "cpu", PHI0)
    with torch.no_grad():
        if mode == "eval":
            x = torch.randn((2, 128, 128, 3), generator=torch.Generator().manual_seed(seed + 1))
            out = Net(PHI0, params, stats).forward(x)
        else:
            g = torch.Generator().manual_seed(seed + 2)
            x = torch.randn((4, 128, 128, 3), generator=g)
            out = Net(PHI0, params, training=True).forward(x, torch.rand((16, 4), generator=g))
    for name in OUTPUTS:
        golden, a = GOLDEN[mode + "_forward_128"][name], out[name].double().reshape(-1)
        assert list(out[name].shape) == golden["shape"], name
        scale = golden["abs_max"]
        assert a[golden["index"]].numpy() == pytest.approx(np.array(golden["values"]), abs=1e-6 * scale), name
        assert float(a.abs().max()) == pytest.approx(scale, rel=1e-6), name
        assert float(a.abs().sum()) == pytest.approx(golden["abs_sum"], rel=1e-6), name
        assert float(a.sum()) == pytest.approx(golden["sum"], abs=1e-6 * golden["abs_sum"]), name


@pytest.mark.parametrize("phi", range(6))
def test_the_widths_are_the_programs_at_every_published_phi(phi):
    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.models.efficientnet import EFFICIENTNET_PARAMS, block_specs, round_filters

    cfg = ModelConfig(phi=phi)
    widths = Widths.of({"backbone": f"efficientnet-b{cfg.backbone_coefficient}",
                        "fpn_num_filters": cfg.fpn_num_filters, "fpn_cell_repeats": cfg.fpn_cell_repeats,
                        "head_repeats": cfg.head_repeats, "pyramid_levels": cfg.num_pyramid_levels,
                        "anchors_per_location": cfg.anchors.num_anchors_per_location})
    theirs = [(s["kernel"], s["stride"], s["expand_ratio"], s["in_ch"], s["out_ch"])
              for s in block_specs(cfg.backbone_coefficient)]
    assert [(b["kernel"], b["stride"], b["expand"], b["in"], b["out"]) for b in widths.blocks()] == theirs
    assert widths.features() == tuple(cfg.conv_channels)
    assert widths.stem == round_filters(32, EFFICIENTNET_PARAMS[cfg.backbone_coefficient][0])


@pytest.mark.parametrize("changes, why", [({"backbone": "efficientnet-b6"}, "phi 6-8"),
                                          ({"pyramid_levels": 6}, "P3-P7"),
                                          ({"anchors_per_location": 12}, "P3-P7")])
def test_networks_the_reference_does_not_hold_are_refused(changes, why):
    with pytest.raises(ValueError, match=why):
        Widths.of(_conf(**changes))


def _program(widths, phi, size, params, stats):
    from harness.train import nest
    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
    from hmd_ego_pose_tpu_torch.models.weights import from_jax_params

    cfg = ModelConfig(phi=phi, image_size=size)
    model = HMDEgoPose(cfg)
    model.load_state_dict(from_jax_params(nest(params), nest(stats), cfg), strict=True)
    return model.eval(), cfg


@pytest.fixture(scope="module")
def phi3():
    widths = Widths.of(_conf(**PHI3))
    params, stats = shapes.draw(torch.Generator().manual_seed(2 ** 31 + 33), "cpu", widths)
    g = torch.Generator().manual_seed(2 ** 31 + 34)
    stats = {k: (torch.rand(v.shape, generator=g) * 0.5 + 0.75 if k.endswith("/var")
                 else torch.randn(v.shape, generator=g) * 0.1) for k, v in stats.items()}
    return widths, params, stats


def test_phi3_tree_has_the_programs_paths_and_shapes(phi3):
    widths, params, stats = phi3
    assert len(widths.blocks()) == 26 and widths.features() == (48, 136, 384) and widths.stem == 40
    model, _ = _program(widths, 3, 128, params, stats)  # strict: every path, every shape
    assert sum(p.numel() for p in model.parameters()) == sum(v.numel() for v in params.values())


def test_phi3_eval_forward_is_the_programs_in_float32(phi3):
    from hmd_ego_pose_tpu_torch.models import hmd_ego_pose

    widths, params, stats = phi3
    model, cfg = _program(widths, 3, 128, params, stats)
    x = torch.randn((2, 128, 128, 3), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        theirs = hmd_ego_pose.apply(model, x, cfg)
        ours = Net(widths, params, stats).forward(x)
    for name in OUTPUTS:
        a, b = ours[name], getattr(theirs, name)
        assert a.shape == b.shape, name
        assert (a - b).abs().max() <= 1e-3 * b.abs().max() + 1e-5, name


def test_phi3_flops_are_the_programs_counter_on_its_own_model():
    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose
    from hmd_ego_pose_tpu_torch.utils.model_stats import forward_flops

    widths = Widths.of(_conf(**PHI3))
    program = forward_flops(HMDEgoPose(ModelConfig(phi=3, image_size=128)).to("meta"), 128)
    assert arith.model_flops(widths, 128, False) == pytest.approx(program, rel=1e-6)
    backbone = arith.forward_flops(widths, 128, "backbone")
    assert 0 < backbone < program
    assert arith.model_flops(widths, 128, True) == pytest.approx(3 * program - 2 * backbone)


def test_phi3_norms_are_the_programs():
    from hmd_ego_pose_tpu_torch.config import ModelConfig
    from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose, apply_train
    from hmd_ego_pose_tpu_torch.nn.core import BatchNorm

    sites = BN.norm_sites(Widths.of(_conf(**PHI3)), 128)
    model = HMDEgoPose(ModelConfig(phi=3, image_size=128))
    seen = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(lambda mod, args, out: seen.append(args[0][0].numel()))
    with torch.no_grad():
        apply_train(model, torch.zeros((1, 128, 128, 3)), model.config)
    # the stem, 2 blocks of 2 norms and 24 of 3; 6 cells of 8 and 6 aligners; 5 heads x 5 levels x 4
    assert len(sites) == 1 + 2 * 2 + 24 * 3 + 6 * 8 + 6 + 5 * 5 * 4 == len(seen) == 231
    assert sorted(seen) == sorted(values for _, values in sites)

