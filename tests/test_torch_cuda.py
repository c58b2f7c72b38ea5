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

from hmd_ego_pose_tpu_torch.kernels import LAUNCHES
from hmd_ego_pose_tpu_torch.ops import distances
from hmd_ego_pose_tpu_torch.ops.quantization import dequantize, dequantize_reference

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
