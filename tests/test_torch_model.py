"""The port's network against the JAX package's, on the same inputs and weights.

Weights come from the JAX ``init`` at phi-0 (BN statistics and fusion
weights randomized so identity defaults can't hide a mapping error) and are
carried across by ``from_jax_params``.  Activations are compared in float32
at 128 px with rtol 2e-3 / atol 2e-4, the bar the JAX package sets its own
torch-converter round trip (tests/test_weights.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmd_ego_pose_tpu.config import ModelConfig as JaxModelConfig
from hmd_ego_pose_tpu.models import hmd_ego_pose as jax_model
from hmd_ego_pose_tpu.models.weights import export_torch_state_dict
from hmd_ego_pose_tpu.nn import core as jax_core
from hmd_ego_pose_tpu_torch.config import ModelConfig
from hmd_ego_pose_tpu_torch.models import hmd_ego_pose
from hmd_ego_pose_tpu_torch.models.folding import fold_batch_norms
from hmd_ego_pose_tpu_torch.models.weights import from_jax_params
from hmd_ego_pose_tpu_torch.nn import core

RTOL, ATOL = 2e-3, 2e-4
F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _randomized_trees(config, seed=0):
    params, state = jax_model.init_host(seed, config)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else rng.normal(0.0, 0.2, a.shape)).astype(np.float32),
        jax.tree.map(np.asarray, state),
    )
    for cell in params["bifpn"]["cells"]:
        for k in [k for k in cell if k.endswith(("_w1", "_w2"))]:
            cell[k] = rng.uniform(0.2, 1.2, cell[k].shape).astype(np.float32)
    return params, state


# ---------------------------------------------------------------------------
# nn/core primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,kernel,stride", [(8, 3, 1), (8, 3, 2), (9, 3, 2), (16, 5, 2), (7, 1, 1), (5, 5, 1)])
def test_same_padding_matches_jax(size, kernel, stride):
    assert core.same_padding(size, kernel, stride) == jax_core.same_padding(size, kernel, stride)


@pytest.mark.parametrize("kernel,stride,depthwise", [(3, 1, False), (3, 2, False), (1, 1, False),
                                                     (3, 2, True), (5, 2, True), (5, 1, True)])
def test_conv_matches_jax(kernel, stride, depthwise):
    rng = np.random.default_rng(kernel * 10 + stride)
    cin = 6
    cout = cin if depthwise else 5
    x = rng.normal(size=(2, 11, 13, cin)).astype(np.float32)
    w = rng.normal(size=(kernel, kernel, 1 if depthwise else cin, cout)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    if depthwise:
        want = jax_core.depthwise_conv_apply({"kernel": jnp.asarray(w)}, jnp.asarray(x), stride)
        conv = core.Conv2dSame(cin, cout, kernel, stride, groups=cin, bias=False)
    else:
        want = jax_core.conv_apply({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x), stride)
        conv = core.Conv2dSame(cin, cout, kernel, stride)
        conv.bias.data = torch.from_numpy(b)
    conv.weight.data = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    got = _nhwc(conv(_nchw(x)).detach())
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_batch_norm_and_swish_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32), "bias": rng.normal(size=8).astype(np.float32)}
    s = {"mean": rng.normal(size=8).astype(np.float32), "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}
    want, _ = jax_core.batch_norm_apply(p, s, jnp.asarray(x))
    bn = core.BatchNorm(8)
    bn.weight.data, bn.bias.data = torch.from_numpy(p["scale"]), torch.from_numpy(p["bias"])
    bn.running_mean.copy_(torch.from_numpy(s["mean"]))
    bn.running_var.copy_(torch.from_numpy(s["var"]))
    got = bn(_nchw(x)).detach()
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_nhwc(core.swish(got, F32)), np.asarray(jax_core.swish(want)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("h,w", [(8, 8), (7, 9), (1, 1)])
def test_max_pool_pads_with_zeros_like_jax(h, w):
    x = -np.abs(np.random.default_rng(h * w).normal(size=(1, h, w, 3))).astype(np.float32) - 1.0
    want = np.asarray(jax_core.max_pool_same(jnp.asarray(x)))
    got = _nhwc(core.max_pool_same(_nchw(x)))
    np.testing.assert_array_equal(got, want)
    assert (got == 0.0).any()  # the zero padding reaches the border windows


def test_resize_nearest_2x_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(core.resize_nearest_2x(_nchw(x))),
                                  np.asarray(jax_core.resize_nearest_2x(jnp.asarray(x))))


def test_config_copy_matches_jax():
    for phi in range(9):
        a, b = ModelConfig(phi=phi), JaxModelConfig(phi=phi)
        for attr in ("backbone_coefficient", "fpn_num_filters", "fpn_cell_repeats", "head_repeats",
                     "num_pyramid_levels", "conv_channels", "num_anchors_per_location", "total_anchors"):
            assert getattr(a, attr) == getattr(b, attr), (phi, attr)


# ---------------------------------------------------------------------------
# the full network
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def phi0_128():
    jcfg = JaxModelConfig(phi=0, image_size=128)
    params, state = _randomized_trees(jcfg)
    x = np.random.default_rng(7).normal(size=(2, 128, 128, 3)).astype(np.float32)

    def run(p, s, images):
        capture = {}
        out, _ = jax_model.apply(p, s, images, jcfg, capture=capture)
        return out, capture

    out, capture = jax.jit(run)(params, state, jnp.asarray(x))
    cfg = ModelConfig(phi=0, image_size=128)
    model = hmd_ego_pose.HMDEgoPose(cfg).eval()
    model.load_state_dict(from_jax_params(params, state, cfg), strict=True)
    return jcfg, cfg, params, state, x, out, capture, model


def test_from_jax_params_matches_export_torch_state_dict(phi0_128):
    jcfg, cfg, params, state, *_ , model = phi0_128
    want = export_torch_state_dict(params, state, jcfg)
    got = from_jax_params(params, state, cfg)
    assert set(got) == set(want) == set(model.state_dict())
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_network_matches_jax_apply_capture(phi0_128):
    _, cfg, _, _, x, out, capture, model = phi0_128
    got_capture = {}
    got = hmd_ego_pose.apply(model, torch.from_numpy(x), cfg, capture=got_capture)
    assert set(got_capture) == set(capture)
    for key, want in capture.items():
        np.testing.assert_allclose(_nhwc(got_capture[key]), np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    for field in ("regression", "classification", "rotation", "translation_raw", "hand"):
        a = getattr(got, field).numpy()
        assert a.shape == np.asarray(getattr(out, field)).shape
        np.testing.assert_allclose(a, np.asarray(getattr(out, field)), rtol=RTOL, atol=ATOL, err_msg=field)


def test_folded_network_equals_unfolded(phi0_128):
    _, cfg, _, _, x, _, _, model = phi0_128
    want = hmd_ego_pose.apply(model, torch.from_numpy(x), cfg)
    folded = fold_batch_norms(model)
    got = hmd_ego_pose.apply(folded, torch.from_numpy(x), cfg)
    for field in ("regression", "classification", "rotation", "translation_raw", "hand"):
        np.testing.assert_allclose(getattr(got, field).numpy(), getattr(want, field).numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=field)
    # the served graph skips the folded BNs; the head BNs stay
    assert not any(isinstance(m, core.BatchNorm) for m in folded.backbone_net.modules())
    assert not any(isinstance(m, core.BatchNorm) for m in folded.bifpn.modules())
    assert sum(isinstance(m, core.BatchNorm) for m in folded.hand_net.modules()) == 15


def test_iterative_refinement_heads_match_jax():
    jcfg = JaxModelConfig(phi=0, image_size=128, iter_steps=1)
    params, state = _randomized_trees(jcfg, seed=1)
    x = np.random.default_rng(8).normal(size=(1, 128, 128, 3)).astype(np.float32)
    out, _ = jax.jit(lambda p, s, i: jax_model.apply(p, s, i, jcfg))(params, state, jnp.asarray(x))
    cfg = ModelConfig(phi=0, image_size=128, iter_steps=1)
    model = hmd_ego_pose.HMDEgoPose(cfg).eval()
    model.load_state_dict(from_jax_params(params, state, cfg), strict=True)
    got = hmd_ego_pose.apply(model, torch.from_numpy(x), cfg)
    for field in ("rotation", "translation_raw", "hand"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(out, field)),
                                   rtol=RTOL, atol=ATOL, err_msg=field)


def test_random_init_is_finite_and_seeded():
    cfg = ModelConfig(phi=0, image_size=128)
    a = hmd_ego_pose.init_weights(hmd_ego_pose.HMDEgoPose(cfg).eval(), torch.Generator().manual_seed(3))
    b = hmd_ego_pose.init_weights(hmd_ego_pose.HMDEgoPose(cfg).eval(), torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    out = hmd_ego_pose.apply(a, torch.zeros(1, 128, 128, 3), cfg)
    assert torch.isfinite(out.hand).all()
    assert float(out.classification.max()) < 0.05  # the focal-loss prior, p = 0.01
