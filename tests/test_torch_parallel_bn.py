"""Cross-replica batch norm: two gloo ranks, each with half of a seeded NCHW
batch, against the single-process BN on the whole batch and against the JAX
package's ``batch_norm_apply(..., axis_name="data")`` under ``shard_map`` over
2 CPU devices.

The output and the input's gradient (rows side by side), the running
statistics, and the gradients of weight and bias (each rank's is its rows'
part: they sum to the whole batch's, and the optimizer's all-reduce adds
them) within 1e-6 of the reference's largest value; with ``update_stats``
on and off (the remat recompute, which still all-reduces).  One packed
all-reduce per application forward, one backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dp_ranks as ranks_mod
from hmd_ego_pose_tpu.config import ParallelConfig as JaxParallelConfig
from hmd_ego_pose_tpu.nn.core import batch_norm_apply
from hmd_ego_pose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hmd_ego_pose_tpu_torch.parallel.mesh import LOCAL

FIELDS = ("y", "x_grad", "weight_grad", "bias_grad", "running_mean", "running_var")


def close(got, want, rel=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return [r[0] for r in ranks_mod.run_ranks(2, [{"kind": "bn"}], tmp_path_factory.mktemp("bn"))]


def gathered(ranks, update_stats):
    """The two ranks' results as one batch's: rows side by side, the parameter
    gradients summed, the running statistics (equal on both ranks) as they are."""
    a, b = ranks[0][update_stats], ranks[1][update_stats]
    out = {k: np.concatenate([a[k], b[k]]) for k in ("y", "x_grad")}
    out.update({k: a[k] + b[k] for k in ("weight_grad", "bias_grad")})
    for k in ("running_mean", "running_var"):
        np.testing.assert_array_equal(a[k], b[k])
        out[k] = a[k]
    return out


def jax_shard_map_bn(update_stats: bool):
    """JAX's cross-replica BN over 2 devices (``update_stats`` False: the input state comes back)."""
    inp = ranks_mod.bn_inputs()
    mesh = jax_make_mesh(JaxParallelConfig(), devices=jax.devices()[:2])
    spec = jax.sharding.PartitionSpec
    params = {"scale": jnp.asarray(inp["weight"]), "bias": jnp.asarray(inp["bias"])}
    state = {"mean": jnp.asarray(inp["mean"]), "var": jnp.asarray(inp["var"])}
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731

    def shard(params, x, cot):
        def f(p, xx):
            y, new_state = batch_norm_apply(p, state, xx, training=True, axis_name="data")
            return jnp.sum(y * cot), (y, new_state)

        (_, (y, new_state)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, x)
        return y, new_state, gp, gx

    fn = jax.shard_map(shard, mesh=mesh, in_specs=(spec(), spec("data"), spec("data")),
                       out_specs=(spec("data"), spec(), spec(), spec("data")))
    y, new_state, gp, gx = jax.jit(fn)(params, nhwc(inp["x"]), nhwc(inp["cotangent"]))
    if not update_stats:
        new_state = state
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    return {"y": nchw(y), "x_grad": nchw(gx), "weight_grad": np.asarray(gp["scale"]),
            "bias_grad": np.asarray(gp["bias"]), "running_mean": np.asarray(new_state["mean"]),
            "running_var": np.asarray(new_state["var"])}


@pytest.mark.parametrize("update_stats", [True, False])
def test_cross_replica_bn_is_the_single_process_bn(ranks, update_stats):
    got, want = gathered(ranks, update_stats), ranks_mod.bn_job({"kind": "bn"}, LOCAL)[update_stats]
    for k in FIELDS:
        close(got[k], want[k])


@pytest.mark.parametrize("update_stats", [True, False])
def test_cross_replica_bn_is_the_jax_shard_map_bn(ranks, update_stats):
    got, want = gathered(ranks, update_stats), jax_shard_map_bn(update_stats)
    for k in FIELDS:
        close(got[k], want[k])


def test_one_all_reduce_per_application_each_way(ranks):
    assert ranks[0]["collectives"] == {"bn": 2, "bn_backward": 2}  # update_stats on, then off
