"""Which path a batch norm takes, and that the CPU's is the formula it always was.

``nn/core.py::BatchNorm`` in training mode runs the hand-written kernels of
``ops/batch_norm.py`` on a CUDA tensor in float32 and the plain version
everywhere else; eval mode is plain.  The kernels themselves run on the card
only (``tests/test_torch_cuda_batch_norm.py``); here the choice is made
observable by pretending the device is a card and recording the calls.
"""

import contextlib
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hmd_ego_pose_tpu_torch import kernels
from hmd_ego_pose_tpu_torch.config import ModelConfig
from hmd_ego_pose_tpu_torch.kernels import LAUNCHES, build
from hmd_ego_pose_tpu_torch.models import folding
from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose, apply, apply_train, init_weights
from hmd_ego_pose_tpu_torch.nn import core
from hmd_ego_pose_tpu_torch.nn.core import BatchNorm, Skip, swish
from hmd_ego_pose_tpu_torch.ops import batch_norm
from hmd_ego_pose_tpu_torch.parallel.mesh import LOCAL

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _norm(channels: int, dtype: torch.dtype, seed: int = 0) -> BatchNorm:
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(channels, dtype=dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(channels, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(channels, generator=g))
        bn.running_mean.copy_(torch.randn(channels, generator=g))
        bn.running_var.copy_(torch.rand(channels, generator=g) + 0.5)
    return bn


def _input(shape, seed: int = 1) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 2.0 + 0.7).astype(np.float32))


def _formula(x, bn, running_mean, running_var):
    """The training norm written out: batch mean and E[x^2] - E[x]^2, the
    running statistics moved by 0.01 with n / (n - 1), the affine in float32."""
    mean = torch.mean(x, dim=(0, 2, 3))
    var = torch.mean(x * x, dim=(0, 2, 3)) - mean * mean
    n = x.shape[0] * x.shape[2] * x.shape[3]
    correction = float(np.float32(n) / np.float32(n - 1))
    new_mean = 0.99 * running_mean + 0.01 * mean
    new_var = 0.99 * running_var + 0.01 * var * correction
    inv = torch.rsqrt(var + 1e-3) * bn.weight
    y = (x - mean[:, None, None]) * inv[:, None, None] + bn.bias[:, None, None]
    return y, new_mean, new_var


@pytest.mark.parametrize("activate", [False, True])
def test_cpu_training_norm_is_the_plain_formula_bit_for_bit(activate):
    bn = _norm(6, torch.float32).train()
    x = _input((3, 6, 5, 7))
    before = (bn.running_mean.clone(), bn.running_var.clone())
    got = bn(x, activate=activate)
    want, mean, var = _formula(x, bn, *before)
    if activate:
        want = swish(want, torch.float32)
    assert torch.equal(got, want)
    assert torch.equal(bn.running_mean, mean) and torch.equal(bn.running_var, var)
    bn.update_stats = False
    bn(x)
    assert torch.equal(bn.running_mean, mean) and torch.equal(bn.running_var, var)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("training", [False, True])
def test_activate_equals_swish_after_the_norm(dtype, training):
    dt = DTYPES[dtype]
    fused, plain = _norm(4, dt).train(training), _norm(4, dt).train(training)
    x = _input((2, 4, 6, 6)).requires_grad_(True)
    x2 = x.detach().clone().requires_grad_(True)
    got = fused(x, activate=True)
    want = swish(plain(x2), dt)
    assert torch.equal(got, want)
    assert torch.equal(fused.running_mean, plain.running_mean)
    assert torch.equal(fused.running_var, plain.running_var)
    got.float().square().sum().backward()
    want.float().square().sum().backward()
    assert torch.equal(x.grad, x2.grad)
    assert torch.equal(fused.weight.grad, plain.weight.grad) and torch.equal(fused.bias.grad, plain.bias.grad)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_skip_applies_the_swish_it_is_asked_for(dtype):
    dt = DTYPES[dtype]
    x = _input((2, 3, 4, 4))
    assert torch.equal(Skip(dt)(x, 8), x)
    assert torch.equal(Skip(dt)(x, 8, activate=True), swish(x, dt))


def test_kernels_are_taken_on_a_card_in_float32_only():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert batch_norm.takes_kernels(cuda, torch.float32)
    assert not batch_norm.takes_kernels(cuda, torch.bfloat16)
    assert not batch_norm.takes_kernels(cpu, torch.float32)
    assert not batch_norm.takes_kernels(cpu, torch.bfloat16)


def test_the_wrapper_refuses_what_the_kernels_do_not_take():
    bn = _norm(3, torch.float32)
    vectors = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    args = (1e-3, 0.01, True, LOCAL, "data", False)
    with pytest.raises(ValueError, match="CUDA"):
        batch_norm.batch_norm_train(_input((2, 3, 4, 4)), *vectors, *args)
    with pytest.raises(ValueError, match="float32"):
        batch_norm.batch_norm_train(_input((2, 3, 4, 4)).double(), *vectors, *args)
    with pytest.raises(ValueError, match="float32"):
        batch_norm.batch_norm_train(_input((2, 4, 4, 4)), *vectors, *args)
    with pytest.raises(ValueError, match="non-empty"):
        batch_norm.batch_norm_train(torch.zeros((0, 3, 4, 4)), *vectors, *args)


@pytest.mark.parametrize("units,channels", [(1, 64), (16, 64), (4096, 64), (16384, 64), (262144, 96),
                                            (262144 * 4, 96), (3, 1152), (99991, 7)])
def test_chunking_covers_every_unit_with_bounded_blocks(units, channels):
    chunks, per = batch_norm.chunking(units, channels)
    assert per % batch_norm.THREADS == 0
    assert batch_norm.THREADS <= per <= batch_norm.THREADS * batch_norm.MAX_UNITS_PER_THREAD
    assert (chunks - 1) * per < units <= chunks * per
    if per < batch_norm.THREADS * batch_norm.MAX_UNITS_PER_THREAD and per > batch_norm.THREADS:
        assert chunks * channels <= 2 * batch_norm.TARGET_BLOCKS


class _Recorder:
    """Stands in for the kernels: records each call's channels and swish and
    returns the plain version's result, so the model runs on."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args, swish: bool):
        x, update_stats = args[0], args[7]
        self.calls.append((x.shape[1], swish, update_stats))
        y = batch_norm.batch_norm_train_reference(*args, dtype=torch.float32)
        return core.swish(y, torch.float32) if swish else y


@pytest.fixture
def as_if_on_a_card(monkeypatch):
    """Every device counts as a card for the choice of path; the kernels'
    wrapper records its calls."""
    real = batch_norm.takes_kernels
    recorder = _Recorder()
    monkeypatch.setattr(batch_norm, "takes_kernels", lambda device, dtype: real(torch.device("cuda"), dtype))
    monkeypatch.setattr(batch_norm, "batch_norm_train", recorder)
    return recorder


def _model(dtype: str, image_size: int = 128) -> tuple:
    config = ModelConfig(phi=0, image_size=image_size, compute_dtype=dtype)
    return init_weights(HMDEgoPose(config), torch.Generator().manual_seed(3)), config


def test_training_forward_takes_the_kernels_at_every_norm_with_the_swish_where_one_follows(as_if_on_a_card):
    model, config = _model("float32")
    images = _input((2, 128, 128, 3))
    out = apply_train(model, images, config)
    calls = as_if_on_a_card.calls
    # 48 backbone norms (stem, 16 depthwise, 15 expand, 16 project), 30 of the
    # BiFPN, 5 heads x 5 levels x 3 repeats
    assert len(calls) == 48 + 30 + 75
    assert sum(swish for _, swish, _ in calls) == 1 + 16 + 15 + 75
    assert all(update for _, _, update in calls)
    out.classification.sum().backward()


def test_bf16_training_and_eval_mode_never_enter_the_kernels(as_if_on_a_card):
    model, config = _model("bfloat16")
    images = _input((2, 128, 128, 3))
    apply_train(model, images, config)
    model32, config32 = _model("float32")
    apply(model32, images, config32)
    apply(folding.fold_batch_norms(model32), images, config32)
    assert as_if_on_a_card.calls == []


def test_launches_on_autograd_threads_go_into_the_capture_tally(monkeypatch):
    class StubLibrary:
        def hegp_stub(self, *args):
            return 0

    monkeypatch.setattr(build, "library", lambda name: StubLibrary())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    LAUNCHES.reset()
    with kernels.recording() as tally:
        kernels.launch("stub", "hegp_stub", torch.device("cuda"))
        other = threading.Thread(target=kernels.launch, args=("stub", "hegp_stub", torch.device("cuda")))
        other.start()
        other.join()
    assert tally == ["stub", "stub"] and LAUNCHES.get("stub") == 0
    LAUNCHES.reset()
