"""The training batch norm's kernels (``csrc/batch_norm.cu``) against the plain version, on the card.

Every test here is ``cuda``-marked and skips where there is no NVIDIA GPU;
the file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_batch_norm.py --noconftest -p no:cacheprovider -q

Shapes are sites of the training cells at batch 16: the largest backbone
norm at 512 px (96 x 256 x 256), a P3 and a P7 head norm at 512 and 256 px,
and an odd plane that takes the kernels' one-float path.

* The output equals the plain version bit for bit given its mean and inv:
  the kernel rounds each step as the plain version does.
* The batch statistics, running statistics, dx, dweight and dbias are
  float32 sums of the same terms in another order than PyTorch's
  reductions.  So each is held to a float64 computation of the same formula:
  its worst error there may be at most 4 times the plain version's own plus
  2**-20 of the largest value (one float32 rounding of a sum has no fixed
  sign; the factor leaves room for the order, not for another formula).
* Two runs, and the replays of a CUDA graph, give the same bits: no atomics.
"""

import pytest
import torch

from hmd_ego_pose_tpu_torch.kernels import LAUNCHES, launch
from hmd_ego_pose_tpu_torch.ops import batch_norm
from hmd_ego_pose_tpu_torch.parallel.mesh import LOCAL
from hmd_ego_pose_tpu_torch.utils import graphs

pytestmark = pytest.mark.cuda

SITES = {
    "backbone-512": (16, 96, 256, 256),
    "p3-512": (16, 64, 64, 64),
    "p7-512": (16, 64, 4, 4),
    "p3-256": (16, 64, 32, 32),
    "p7-256": (16, 64, 2, 2),
    "odd": (3, 5, 7, 9),
}
EPS, MOMENTUM = 1e-3, 0.01


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _site(shape, device, seed: int = 0):
    """x (with a channel offset, so that E[x^2] - E[x]^2 cancels as a trained
    activation's does), the upstream gradient, and the norm's four vectors."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=g, device=device) * 1.5 + torch.randn(c, 1, 1, generator=g, device=device)
    up = torch.randn(shape, generator=g, device=device)
    weight = torch.rand(c, generator=g, device=device) + 0.5
    bias = torch.randn(c, generator=g, device=device)
    running = (torch.randn(c, generator=g, device=device), torch.rand(c, generator=g, device=device) + 0.5)
    return x, up, weight, bias, running


def _plain(x, weight, bias, running, swish: bool, update: bool = True):
    y = batch_norm.batch_norm_train_reference(x, weight, bias, *running, EPS, MOMENTUM, update, LOCAL, "data",
                                              torch.float32)
    return y * (1.0 / (1.0 + torch.exp(-y))) if swish else y


def _exact(x, weight, bias, running, swish: bool, update: bool = True):
    """The same formula in float64."""
    mean = x.mean(dim=(0, 2, 3))
    var = (x * x).mean(dim=(0, 2, 3)) - mean * mean
    n = x.shape[0] * x.shape[2] * x.shape[3]
    if update:
        with torch.no_grad():
            running[0].copy_((1 - MOMENTUM) * running[0] + MOMENTUM * mean)
            running[1].copy_((1 - MOMENTUM) * running[1] + MOMENTUM * var * n / (n - 1))
    y = (x - mean[:, None, None]) * (torch.rsqrt(var + EPS) * weight)[:, None, None] + bias[:, None, None]
    return y * torch.sigmoid(y) if swish else y


def _kernel(x, weight, bias, running, swish: bool, update: bool = True, mesh=LOCAL):
    return batch_norm.batch_norm_train(x, weight, bias, *running, EPS, MOMENTUM, update, mesh, "data", swish)


def _grads(fn, x, weight, bias, up):
    x, weight, bias = (t.detach().clone().requires_grad_(True) for t in (x, weight, bias))
    y = fn(x, weight, bias)
    y.backward(up.to(y.dtype))
    return y.detach(), x.grad, weight.grad, bias.grad


def _kernel_stats(x, weight):
    """The forward's statistics launch alone: rows mean, mean_sq, rstd, inv."""
    n, c, h, w = x.shape
    vec = 4 if (h * w) % 4 == 0 else 1
    chunks, per = batch_norm.chunking(n * h * w // vec, c)
    partial = torch.empty((c, chunks, 2), device=x.device)
    stats = torch.empty((4, c), device=x.device)
    spare = torch.empty(c, device=x.device)
    launch("batch_norm", "hegp_bn_stats", x.device, x.data_ptr(), partial.data_ptr(), stats.data_ptr(),
           weight.data_ptr(), spare.data_ptr(), spare.data_ptr(), n, c, h * w, chunks, per, vec, float(n * h * w),
           EPS, 1 - MOMENTUM, MOMENTUM, 1.0, 1, 0)
    return stats


def _held(got, plain, exact, what):
    """got's worst error against float64 at most 4x the plain version's own plus 2**-20 of the largest value."""
    exact = exact.double()
    err, plain_err = (got.double() - exact).abs().max().item(), (plain.double() - exact).abs().max().item()
    limit = 4 * plain_err + 2 ** -20 * exact.abs().max().item()
    assert err <= limit, f"{what}: error {err:.3e} against float64, plain {plain_err:.3e}, limit {limit:.3e}"


@pytest.mark.parametrize("swish", [False, True])
@pytest.mark.parametrize("site", list(SITES))
def test_output_bit_equal_to_plain_given_its_mean_and_inv(cuda_device, site, swish):
    x, _, weight, bias, _ = _site(SITES[site], cuda_device)
    n, c, h, w = x.shape
    mean = torch.mean(x, dim=(0, 2, 3))
    mean_sq = torch.mean(x * x, dim=(0, 2, 3))
    var = mean_sq - mean * mean
    rstd = torch.rsqrt(var + EPS)
    inv = rstd * weight
    want = (x - mean[:, None, None]) * inv[:, None, None] + bias[:, None, None]
    if swish:
        want = want * (1.0 / (1.0 + torch.exp(-want)))
    stats = torch.stack([mean, mean_sq, rstd, inv]).contiguous()
    y = torch.empty_like(x)
    LAUNCHES.reset()
    launch("batch_norm", "hegp_bn_apply", cuda_device, x.data_ptr(), y.data_ptr(), stats.data_ptr(), bias.data_ptr(),
           n, c, h * w, 4 if (h * w) % 4 == 0 else 1, int(swish))
    torch.cuda.synchronize()
    assert torch.equal(y, want)
    assert LAUNCHES.snapshot() == {"batch_norm": 1}


@pytest.mark.parametrize("site", list(SITES))
def test_batch_statistics_within_float32_rounding(cuda_device, site):
    x, _, weight, _, _ = _site(SITES[site], cuda_device)
    stats = _kernel_stats(x, weight)
    x64 = x.double()
    mean64, mean_sq64 = x64.mean(dim=(0, 2, 3)), (x64 * x64).mean(dim=(0, 2, 3))
    var64 = mean_sq64 - mean64 * mean64
    mean, mean_sq = torch.mean(x, dim=(0, 2, 3)), torch.mean(x * x, dim=(0, 2, 3))
    var = mean_sq - mean * mean
    _held(stats[0], mean, mean64, "mean")
    _held(stats[1], mean_sq, mean_sq64, "mean_sq")
    _held(stats[2], torch.rsqrt(var + EPS), torch.rsqrt(var64 + EPS), "rstd")
    _held(stats[3], torch.rsqrt(var + EPS) * weight, torch.rsqrt(var64 + EPS) * weight.double(), "inv")


@pytest.mark.parametrize("update", [True, False])
@pytest.mark.parametrize("swish", [False, True])
@pytest.mark.parametrize("site", list(SITES))
def test_running_statistics_and_gradients_within_float32_rounding(cuda_device, site, swish, update):
    x, up, weight, bias, running = _site(SITES[site], cuda_device)
    runs = {k: tuple(r.clone() for r in running) for k in ("kernel", "plain")}
    runs["exact"] = tuple(r.double() for r in running)
    LAUNCHES.reset()
    got = _grads(lambda a, b, c: _kernel(a, b, c, runs["kernel"], swish, update), x, weight, bias, up)
    assert LAUNCHES.snapshot() == {"batch_norm": 4}  # statistics, output; gradient sums, dx
    plain = _grads(lambda a, b, c: _plain(a, b, c, runs["plain"], swish, update), x, weight, bias, up)
    exact = _grads(lambda a, b, c: _exact(a, b, c, runs["exact"], swish, update),
                   x.double(), weight.double(), bias.double(), up.double())
    for what, k, p, e in zip(("y", "dx", "dweight", "dbias"), got, plain, exact):
        _held(k, p, e, what)
    if not update:
        assert all(torch.equal(k, r) for k, r in zip(runs["kernel"], running))
    for k, p, e, what in zip(runs["kernel"], runs["plain"], runs["exact"], ("running_mean", "running_var")):
        _held(k, p, e, what)


@pytest.mark.parametrize("site", ["p3-256", "odd"])
def test_two_runs_and_the_mesh_path_give_the_same_bits(cuda_device, site):
    x, up, weight, bias, running = _site(SITES[site], cuda_device)

    class OneRankMesh:
        """A mesh that makes its collectives over one rank: the split path
        (the all-reduce between the sums and the finalisation) at world 1."""

        world, space = 1, 1

        def reduces(self, over):
            return True

        def all_reduce_mean(self, tensors, kind, over="data"):
            flat = torch.cat([t.reshape(-1) for t in tensors]) / 1
            return [p.view_as(t) for t, p in zip(tensors, flat.split([t.numel() for t in tensors]))]

    outs = []
    for mesh in (LOCAL, LOCAL, OneRankMesh()):
        stats = tuple(r.clone() for r in running)
        got = _grads(lambda a, b, c: _kernel(a, b, c, stats, True, True, mesh), x, weight, bias, up)
        outs.append(got + stats)
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


@pytest.mark.parametrize("swish", [False, True])
def test_captured_forward_and_backward_replay_the_eager_bits(cuda_device, swish):
    x, up, weight, bias, running = _site(SITES["p3-512"], cuda_device)
    x = x.requires_grad_(True)
    w, b = (t.clone().requires_grad_(True) for t in (weight, bias))
    eager_stats = tuple(r.clone() for r in running)
    graph_stats = tuple(r.clone() for r in running)

    def step(stats):
        for t in (x, w, b):
            t.grad = None
        y = _kernel(x, w, b, stats, swish)
        y.backward(up)
        return y.detach(), x.grad, w.grad, b.grad

    want = [t.clone() for t in step(eager_stats)]
    LAUNCHES.reset()
    graph = graphs.capture(lambda: step(graph_stats), cuda_device)  # a warm-up call and the capture
    assert graph.launches == ("batch_norm",) * 4
    for moved, start in zip(graph_stats, running):  # the warm-up moved them once
        moved.copy_(start)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(want, graph.outputs))
    assert all(torch.equal(a, b) for a, b in zip(eager_stats, graph_stats))
    assert LAUNCHES.get("batch_norm") == 4 + 4  # the warm-up's launches, then the replay's
