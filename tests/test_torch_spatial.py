"""The port's ``space`` and ``model`` mesh axes against the JAX package's
unsharded functions, as ``tests/test_parallel_spatial.py`` holds the JAX
package's spatial programs.

phi-0, 128 px, fp32, the shipped artifact's weights (``iter_steps=1``: with
``chip_smoke.add_iter_leaves``' seeded subnets); the seeded inputs of
``tests/torch_dp_ranks.py::spatial_inputs`` (those of the JAX test).  The
ranks are gloo subprocesses on the CPU (``torch_dp_ranks.run_ranks``, four
of them), each job on a mesh of its own layout (data, model, space):

* the raw forward at space 4 (P6 and P7 whole on every rank) and at model 2
  x space 2: the five outputs within rtol 2e-4, atol 2e-5 of JAX's;
* the fused predict at data 2 x space 2 (the dry run's hybrid): labels
  equal, scores 1e-4, boxes 1e-3, translation 1e-2;
* a train step at data 2 x space 2, batch 4 (the JAX test's batch): the
  loss within rtol 1e-4 of JAX's step, every parameter within 5e-3 of
  JAX's (the JAX test's bound), the six losses within 1e-5 relative of the
  port's single-process step, every rank's gradients after the all-reduce
  within 1e-4 of each leaf's norm plus 1e-6 of the global norm of the
  single-process step's, and the state digests equal on every rank; at
  ``iter_steps=1`` with drop-connect (the shared heads and refinement
  subnets get gradients from slabs and from the whole P7) and at data 2 x
  model 2, the same against the single-process step (whose iter-1 step
  ``tests/test_torch_cli_rest.py`` holds to JAX's);
* the engine on a space-4 mesh: batch floor 1, finite poses equal to the
  single-process engine's;
* the same jobs through the card's CUDA graphs, stood in for on the CPU
  (``torch_dp_ranks.standin_graphs``: the warm-up runs, the capture
  records the collectives, a replay runs the call again with them tallied):
  the spatial step at data 2 x space 2 through ``HostGraph`` (a replay from
  the start) bit-equal to the eager spatial step in losses, gradients and
  state, its collectives by kind the eager step's, and within the bounds
  above of JAX's step; evaluation's predict (``EvalForward``: whole frames
  in, the slab cut in the graph) at data 2 x space 2 and space 4 equal to
  the eager spatial predict; the engine's "batch" graphs on the space-4
  mesh answering as the eager space engine; ``Trainer.fit`` at data 2 x
  space 2 through the step's graph and ``EvalForward``, one validation:
  process 0's space group validates (the same scalars on both its ranks),
  every rank holds process 0's metric, and process 0 alone logs and writes
  checkpoints;
* the space probe of ``chip_smoke.py`` (``probe_space_mesh``: one rank that
  acts as space rank 0 of two, the other mirrored) on a one-rank gloo
  group of this process: its step makes the collectives of rank 0 of a
  data 1 x space 2 step (the ranks' data 1 x model 2 x space 2 job; the
  model axis makes none), and two of its steps from one state are
  bit-equal and finite.

The ops are held without ranks: ``ThreadMesh`` runs the ranks of a space
group as threads of this process, with the mesh's collective interface;
each window op on slabs (k 1, 3, 5; stride 1, 2; halos within a slab, deeper
than one, and levels the axis does not divide) against the op on the whole
level, its backward against autograd of the whole tensor.
"""

import concurrent.futures
import copy
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_dp_ranks as ranks_mod
from hmd_ego_pose_tpu.config import Config as JaxConfig
from hmd_ego_pose_tpu.config import ModelConfig as JaxModelConfig
from hmd_ego_pose_tpu.config import TrainConfig as JaxTrainConfig
from hmd_ego_pose_tpu.models import hmd_ego_pose as jax_model
from hmd_ego_pose_tpu.train import checkpoint as jax_checkpoint
from hmd_ego_pose_tpu.train import step as jax_step
from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.config import ModelConfig
from hmd_ego_pose_tpu_torch.models.weights import to_jax_params
from hmd_ego_pose_tpu_torch.nn import core
from hmd_ego_pose_tpu_torch.parallel import spatial
from hmd_ego_pose_tpu_torch.parallel.mesh import DataMesh
from hmd_ego_pose_tpu_torch.train.checkpoint import load_model
from hmd_ego_pose_tpu_torch.train.step import METRIC_NAMES

SIZE = ranks_mod.SPATIAL_SIZE


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
OUTPUTS = ("classification", "regression", "rotation", "translation_raw", "hand")


# ---------------------------------------------------------------------------
# the ops, on the ranks of a space group run as threads
# ---------------------------------------------------------------------------


class _Rendezvous:
    def __init__(self, n: int):
        self.barrier, self.slots = threading.Barrier(n, timeout=30), [None] * n


class ThreadMesh(DataMesh):
    """Space rank ``space_rank`` of ``space`` threads: ``all_gather`` and
    ``all_reduce_sum_`` over the threads, as the mesh's over its space group."""

    def __init__(self, space: int, space_rank: int, rendezvous: _Rendezvous):
        super().__init__(rank=0, world=1, device=torch.device("cpu"), space=space, space_rank=space_rank)
        self.rendezvous = rendezvous

    def _exchange(self, tensor):
        rv = self.rendezvous
        rv.barrier.wait()
        rv.slots[self.space_rank] = tensor.clone()
        rv.barrier.wait()
        parts = list(rv.slots)
        rv.barrier.wait()
        return parts

    def all_gather(self, tensor, kind, over="space"):
        assert over == "space"
        self.stats.add(kind, 0.0)
        return self._exchange(tensor)

    def all_reduce_sum_(self, tensor, kind, over="data"):
        assert over == "space"
        self.stats.add(kind, 0.0)
        tensor.copy_(sum(self._exchange(tensor)))
        return tensor


def on_threads(space: int, fn):
    """``fn(mesh)`` on ``space`` threads, one ``ThreadMesh`` each; their results."""
    rv, results, errors = _Rendezvous(space), [None] * space, []

    def run(r):
        try:
            results[r] = fn(ThreadMesh(space, r, rv))
        except BaseException as exc:  # noqa: BLE001 - re-raised in the test's thread
            errors.append(exc)
            rv.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(space)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errors:
        raise errors[0]
    return results


def slabs(x: torch.Tensor, space: int):
    return list(x.chunk(space, dim=-2))


@pytest.mark.parametrize("height,space,kernel,stride", [
    (16, 2, 1, 1), (16, 2, 1, 2), (16, 2, 3, 1), (16, 2, 3, 2), (16, 4, 5, 1), (16, 4, 5, 2),
    (4, 4, 5, 1),  # a halo of 2 rows around slabs of 1: the whole level gathered
    (4, 4, 3, 2),  # 4 rows split, 2 rows not: the input gathered, the output whole
    (2, 4, 3, 1),  # a level the axis does not divide: whole on every rank
    (6, 3, 3, 2),  # an axis of 3: slabs of 2 rows, padding (0, 1), output slabs of 1
])
def test_window_conv_on_slabs_matches_the_whole_level(height, space, kernel, stride):
    """SAME padding from the whole height (asymmetric at stride 2), halo rows
    from the neighbours: the slabs' outputs are the whole conv's rows; the
    input gradients its rows, the weight gradients summed over the ranks its."""
    torch.manual_seed(height * 100 + kernel * 10 + stride)
    x = torch.randn(2, 3, height, 5)
    conv = core.Conv2dSame(3, 3, kernel, stride, groups=3 if kernel > 1 else 1, bias=True)
    with torch.no_grad():
        conv.weight.normal_()
        conv.bias.normal_()
    whole_x = x.clone().requires_grad_(True)
    want = conv(whole_x)
    cotangent = torch.randn_like(want)
    want.backward(cotangent)
    out_h = want.shape[-2]
    split_in = height % space == 0

    def run(mesh):
        c = copy.deepcopy(conv)
        c.mesh = mesh
        c.zero_grad()
        xs = (slabs(x, space)[mesh.space_rank] if split_in else x).clone().requires_grad_(True)
        y = c(xs, height)
        g = slabs(cotangent, space)[mesh.space_rank] if mesh.sharded(out_h) else cotangent / space
        y.backward(g)
        return y.detach(), xs.grad, c.weight.grad, c.bias.grad

    results = on_threads(space, run)
    got = torch.cat([r[0] for r in results], -2) if out_h % space == 0 else results[0][0]
    torch.testing.assert_close(got, want.detach(), rtol=1e-5, atol=1e-5)
    grad = torch.cat([r[1] for r in results], -2) if split_in else sum(r[1] for r in results)
    torch.testing.assert_close(grad, whole_x.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sum(r[2] for r in results), conv.weight.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sum(r[3] for r in results), conv.bias.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("height,space", [(8, 2), (4, 4), (2, 2), (1, 2)])
def test_max_pool_and_upsample_on_slabs_match_the_whole_level(height, space):
    x = torch.randn(2, 3, height, 4)
    pooled, upsampled = core.max_pool_same(x), core.resize_nearest_2x(x)

    def run(mesh):
        xs = slabs(x, space)[mesh.space_rank] if mesh.sharded(height) else x
        return core.max_pool_same(xs, full_h=height, mesh=mesh), core.resize_nearest_2x(xs, height, mesh)

    results = on_threads(space, run)
    for i, want in enumerate((pooled, upsampled)):
        got = torch.cat([r[i] for r in results], -2) if want.shape[-2] % space == 0 else results[0][i]
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_gather_scatter_and_space_sum_backward_against_autograd():
    """gather: each rank's part of the whole level's gradient summed and cut to
    its slab; scatter: the slab's gradient placed in zeros (summed over the
    ranks: the whole gradient); space_sum: the parts' sum on every rank."""
    space = 4
    x = torch.randn(2, 3, 8, 5)
    weights = torch.randn(2, 3, 8, 5)
    whole = x.clone().requires_grad_(True)
    (whole * weights).sum().backward()

    def run(mesh):
        xs = slabs(x, space)[mesh.space_rank].clone().requires_grad_(True)
        gathered = spatial.gather_rows(xs, mesh)
        (gathered * weights / space).sum().backward()
        xw = x.clone().requires_grad_(True)
        scattered = spatial.scatter_rows(xw, mesh)
        (scattered * slabs(weights, space)[mesh.space_rank]).sum().backward()
        xt = slabs(x, space)[mesh.space_rank].clone().requires_grad_(True)
        total = spatial.space_sum(xt.sum(dim=(2, 3)), mesh)
        (total * 1.0).sum().backward()
        return gathered.detach(), xs.grad, xw.grad, total.detach(), xt.grad

    results = on_threads(space, run)
    for r in results:
        torch.testing.assert_close(r[0], x)
        torch.testing.assert_close(r[3], x.sum(dim=(2, 3)), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(r[4], torch.full_like(r[4], float(space)))
    torch.testing.assert_close(torch.cat([r[1] for r in results], -2), whole.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sum(r[2] for r in results), whole.grad)
    assert results[0][4].shape == (2, 3, 2, 5)


def test_single_device_path_needs_no_heights():
    """With no space axis every op is the single-device op; under one, a window
    op without its level's height raises instead of guessing."""
    x = torch.randn(1, 2, 6, 6)
    conv = core.Conv2dSame(2, 2, 3, 2, groups=2)
    assert torch.equal(conv(x), conv(x, 6))
    conv.mesh = DataMesh(rank=0, world=1, device=torch.device("cpu"), space=2)
    with pytest.raises(ValueError, match="height"):
        conv(x)


# ---------------------------------------------------------------------------
# the model, the step and the engine on gloo ranks, against JAX
# ---------------------------------------------------------------------------


def _job(what, layout, batch, seed, state, **extra):
    return {"kind": "spatial", "what": what, "layout": layout, "batch": batch, "seed": seed, "state": state,
            **extra}


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    """The artifact's and the iter-1 checkpoint's weights as the port's state
    files, and a synthetic dataset of eight frames (the fit job's)."""
    work = tmp_path_factory.mktemp("spatial_states")
    iter1, _, _ = chip_smoke.write_iter1_checkpoint(str(work), "cpu")
    out = {"dataset": str(work / "syn")}
    cli.main(["make-synthetic", "--out-dir", out["dataset"], "--num-frames", "8", "--frame-size", str(SIZE),
              "--hand-render-version", "3"])
    for name, path, iters in (("artifact", ranks_mod.ARTIFACT, 0), ("iter1", iter1, 1)):
        cfg = ModelConfig(phi=0, image_size=SIZE, compute_dtype="float32", iter_steps=iters)
        model, _ = load_model(path, cfg, device="cpu")
        out[name] = str(work / f"{name}.pt")
        torch.save(model.state_dict(), out[name])
    return out


def jobs(states):
    art, it1 = states["artifact"], states["iter1"]
    return {
        "forward_space4": _job("forward", [1, 1, 4], 1, 0, art),
        "forward_model2_space2": _job("forward", [1, 2, 2], 1, 0, art),
        "predict": _job("predict", [2, 1, 2], 2, 1, art),
        "step": _job("step", [2, 1, 2], 4, 2, art),
        "step_iter1_drop_connect": _job("step", [2, 1, 2], 4, 2, it1, model={"iter_steps": 1},
                                        drop_connect_seed=5),
        "step_model2": _job("step", [2, 2, 1], 4, 2, art),
        "step_model2_space2": _job("step", [1, 2, 2], 4, 2, art),
        "engine": _job("engine", [1, 1, 4], 3, 5, art),
        "step_graph": _job("step", [2, 1, 2], 4, 2, art, graph=True),
        "predict_graph": _job("predict", [2, 1, 2], 2, 1, art, graph=True),
        "predict_graph_space4": _job("predict", [1, 1, 4], 1, 0, art, graph=True),
        "engine_graph": _job("engine", [1, 1, 4], 3, 5, art, graph=True),
        "fit_graph": {"kind": "spatial_fit", "layout": [2, 1, 2], "dataset": states["dataset"], "size": SIZE,
                      "batch": 4, "oversample": 2, "eval_images": 2},
    }


@pytest.fixture(scope="module")
def pending_ranks(states, tmp_path_factory):
    """The four ranks running every job, started in a thread of their own."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(ranks_mod.run_ranks, 4, list(jobs(states).values()),
                          tmp_path_factory.mktemp("spatial_ranks"), timeout=300)


@pytest.fixture(scope="module")
def runs(states, pending_ranks, jax_step_result, jax_forward, jax_predict):
    """name -> (the single-process job's result, [the four ranks' results]);
    the JAX functions compile and run while the ranks run.  Jobs that differ only in
    their layout or in running through the graphs share one single-process run;
    the fit job has none."""
    single, seen = {}, {}
    for name, job in jobs(states).items():
        if job["kind"] != "spatial":
            single[name] = None
            continue
        key = json.dumps({k: v for k, v in job.items() if k not in ("layout", "graph")}, sort_keys=True)
        if key not in seen:
            seen[key] = ranks_mod.spatial_job(job)
        single[name] = seen[key]
    ranks = pending_ranks.result()
    return {name: (single[name], [r[i] for r in ranks]) for i, name in enumerate(single)}


def _jax_cfg(iters=0):
    return JaxModelConfig(phi=0, image_size=SIZE, compute_dtype="float32", iter_steps=iters)


@pytest.fixture(scope="module")
def jax_trees():
    """The artifact's (params, bn_state) as the JAX package restores them."""
    return jax_checkpoint.restore_checkpoint(ranks_mod.ARTIFACT)[:2]


@pytest.fixture(scope="module")
def jax_forward(jax_trees):
    """The JAX package's unsharded forward of the forward jobs' image."""
    params, bn_state = jax_trees
    images = ranks_mod.spatial_inputs("forward", 1, 0)["images"]
    return jax.jit(lambda p, s, x: jax_model.apply(p, s, x, _jax_cfg(), training=False))(
        params, bn_state, jnp.asarray(images))[0]


@pytest.mark.parametrize("name", ["forward_space4", "forward_model2_space2"])
def test_spatial_forward_matches_jax(runs, jax_forward, name):
    want = jax_forward
    single, ranks = runs[name]
    for r in ranks:
        for key in OUTPUTS:
            np.testing.assert_allclose(r["outputs"][key], np.asarray(getattr(want, key)), rtol=2e-4, atol=2e-5,
                                       err_msg=f"{key} on rank {r['coords']}")
            np.testing.assert_allclose(r["outputs"][key], single["outputs"][key], rtol=2e-4, atol=2e-5)
    if name == "forward_model2_space2":  # the model axis replicates: both replicas compute the same
        by_coords = {tuple(r["coords"]): r["outputs"] for r in ranks}
        for s in range(2):
            for key in OUTPUTS:
                np.testing.assert_array_equal(by_coords[(0, 0, s)][key], by_coords[(0, 1, s)][key])


@pytest.fixture(scope="module")
def jax_predict(jax_trees):
    """The JAX package's unsharded fused predict of the predict job's batch."""
    params, bn_state = jax_trees
    inp = ranks_mod.spatial_inputs("predict", 2, 1)
    return jax.jit(lambda p, s, x, c: jax_model.predict(
        p, s, x, c, _jax_cfg(), score_threshold=0.05, iou_threshold=0.5, max_detections=10))(
        params, bn_state, jnp.asarray(inp["images"]), jnp.asarray(inp["cams"]))


def test_hybrid_predict_matches_jax(runs, jax_predict):
    want = jax_predict
    _, ranks = runs["predict"]
    assert sorted(tuple(r["rows"]) for r in ranks) == [(0, 1), (0, 1), (1, 2), (1, 2)]
    assert int(np.asarray(want.num_valid).sum()) > 0  # the artifact detects on these frames
    for r in ranks:
        rows, det = slice(*r["rows"]), r["detections"]
        np.testing.assert_array_equal(det["labels"], np.asarray(want.labels)[rows])
        np.testing.assert_allclose(det["scores"], np.asarray(want.scores)[rows], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(det["boxes"], np.asarray(want.boxes)[rows], rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(det["translation"], np.asarray(want.translation)[rows], rtol=1e-3, atol=1e-2)


@pytest.fixture(scope="module")
def jax_step_result(jax_trees):
    """The JAX package's unsharded step (drop-connect off: its losses get no
    key) from the artifact, on the step jobs' batch: (loss, params)."""
    original = jax_step._compute_losses
    jax_step._compute_losses = lambda params, bn, batch, rng, *a: original(params, bn, batch, None, *a)
    try:
        inp = ranks_mod.spatial_inputs("step", 4, 2)
        batch = jax_step.Batch(
            images=jnp.asarray(inp["images"]), camera_parameters=jnp.asarray(inp["cams"]),
            gt_boxes=jnp.asarray(inp["gt_boxes"]), gt_labels=jnp.asarray(inp["gt_labels"]),
            gt_transformation=jnp.asarray(inp["gt_transformation"]), gt_coords_3d=jnp.asarray(inp["gt_coords_3d"]),
            gt_valid=jnp.asarray(inp["gt_valid"]))
        cfg = JaxConfig(model=_jax_cfg(), train=JaxTrainConfig(batch_size=4, learning_rate=1e-3))
        step = jax_step.make_train_step(cfg, inp["model_points"])
        params, bn_state = jax.tree.map(lambda x: jnp.array(x, copy=True), jax_trees)
        new, metrics = step.jitted(step.init_state(params, bn_state), batch, jax.random.PRNGKey(0))
        return float(metrics["loss"]), jax.tree.map(np.asarray, new.params)
    finally:
        jax_step._compute_losses = original


def _largest_param_gap(state: dict, want_params) -> float:
    cfg = ModelConfig(phi=0, image_size=SIZE, compute_dtype="float32")
    got, _ = to_jax_params({k: torch.from_numpy(v) for k, v in state.items()}, cfg)
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want_params)))


def _hold_to_single(single: dict, ranks: list) -> None:
    """Losses within 1e-5 relative; every rank's gradients, after the (data x
    space) all-reduce and before Adam, within 1e-4 of each leaf's norm plus
    1e-6 of the global norm G of the single-process step's (the data-parallel
    tests' bound); the parameters after the step within 5e-3."""
    assert len({r["digest"] for r in ranks}) == 1, "the ranks' parameters or BN buffers differ"
    g_norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in single["grads"].values())))
    assert g_norm > 0
    for r in ranks:
        for term in METRIC_NAMES:
            assert r["metrics"][term] == pytest.approx(single["metrics"][term], rel=1e-5), term
        assert r["grads"].keys() == single["grads"].keys()
        off = {}
        for key, want in single["grads"].items():
            gap = float(np.linalg.norm(r["grads"][key] - want))
            if not gap <= 1e-4 * float(np.linalg.norm(want)) + 1e-6 * g_norm:
                off[key] = (gap, float(np.linalg.norm(want)))
        assert not off, f"rank {r['coords']}: gradients off the single-process step's (gap, norm): {off}"
    gap = max(float(np.abs(v - single["state"][k]).max()) for k, v in ranks[0]["state"].items())
    assert gap < 5e-3, gap


def test_spatial_train_step_matches_jax(runs, jax_step_result):
    single, ranks = runs["step"]
    _hold_to_single(single, ranks)
    loss, params = jax_step_result
    assert ranks[0]["metrics"]["loss"] == pytest.approx(loss, rel=1e-4)
    gap = _largest_param_gap(ranks[0]["state"], params)
    assert gap < 5e-3, f"params diverged from JAX's: max abs diff {gap}"


@pytest.mark.parametrize("name", ["step_iter1_drop_connect", "step_model2", "step_model2_space2"])
def test_spatial_and_model_steps_match_the_single_process_step(runs, name):
    """The refinement subnets on the gradient path, with drop-connect drawn
    per sample of the global batch (every space rank of a data row the same
    masks); a model axis of 2 gives the data-only result."""
    single, ranks = runs[name]
    _hold_to_single(single, ranks)


def test_spatial_step_collectives(runs):
    """One packed gradient all-reduce and one of the losses a step; a halo per
    window op of a split level, a gather per head output of one, both with
    their backward; a space sum per squeeze-excite."""
    _, ranks = runs["step"]
    calls = ranks[0]["collectives"]
    assert calls["grads"] == 1 and calls["metrics"] == 1 and calls["space_sum"] == 16
    assert calls["gather"] == calls["gather_backward"] == 24  # 5 heads x 4 split levels, the translation's 2 as 1
    assert calls["halo"] > calls["halo_backward"] > 0  # the frozen backbone's halos carry no gradient back


def test_engine_on_a_space_mesh(runs):
    single, ranks = runs["engine"]
    leader = next(r for r in ranks if "poses" in r)
    assert [r["batch_sizes"][0] for r in ranks] == [1] * 4  # a pure-space mesh: no batch floor
    assert sorted(r.get("served", 0) for r in ranks) == [0, 3, 3, 3]
    assert len(leader["poses"]) == 3 and all(p is not None for p in leader["poses"])
    for got, want in zip(leader["poses"], single["poses"]):
        for g, w in zip(got, want):
            assert np.all(np.isfinite(g))
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the same through the card's CUDA graphs, stood in for on the CPU
# ---------------------------------------------------------------------------


def _without(calls: dict, *kinds) -> dict:
    return {k: v for k, v in calls.items() if k not in kinds}


def test_graphed_spatial_step_equals_the_eager_spatial_step(runs, jax_step_result):
    """A replay of the step's graph from the start is the eager step: losses,
    gradients after the (data x space) all-reduce and state, bit for bit."""
    _, eager = runs["step"]
    single, graphed = runs["step_graph"]
    assert {r["graph_class"] for r in graphed} == {"StandinGraph"}
    for g, e in zip(graphed, eager):
        assert g["coords"] == e["coords"]
        assert g["metrics"] == e["metrics"]
        assert g["digest"] == e["digest"]
        assert g["grads"].keys() == e["grads"].keys()
        for key, want in e["grads"].items():
            np.testing.assert_array_equal(g["grads"][key], want, err_msg=key)
    _hold_to_single(single, graphed)
    loss, params = jax_step_result
    assert graphed[0]["metrics"]["loss"] == pytest.approx(loss, rel=1e-4)
    assert _largest_param_gap(graphed[0]["state"], params) < 5e-3


def test_a_spatial_step_replay_counts_the_eager_steps_collectives(runs):
    """The capture's tally, and what a replay counts, by kind: the eager
    spatial step's (halos, gathers, space sums, BN over data and over
    (data x space), with their backward; the gradients; the losses)."""
    _, eager = runs["step"]
    _, graphed = runs["step_graph"]
    for g, e in zip(graphed, eager):
        want = _without(e["collectives"], "replicate")
        assert {"halo", "halo_backward", "gather", "gather_backward", "space_sum", "bn", "grads"} <= set(want)
        assert g["tally"] == want and g["replay_collectives"] == want


@pytest.mark.parametrize("name", ["predict_graph", "predict_graph_space4"])
def test_graphed_spatial_predict_equals_the_eager_spatial_predict(runs, name):
    """``EvalForward`` on a space mesh: one capture; each replay's six fields
    equal to its eager predict's, and at data 2 x space 2 to the eager
    spatial predict of the slab; whole on every rank of a space group; a
    replay counts the capture's halos and gathers."""
    _, ranks = runs[name]
    for r in ranks:
        assert r["captures"] == 1
        assert r["tally"] == r["replay_collectives"] and r["tally"]["halo"] > 0 and r["tally"]["gather"] > 0
        for replay in r["replays"]:
            for field, want in r["eager"].items():
                np.testing.assert_array_equal(replay[field], want, err_msg=field)
        peer = next(q for q in ranks if q["rows"] == r["rows"])  # the space group's first rank
        for field, want in peer["eager"].items():
            np.testing.assert_array_equal(r["eager"][field], want, err_msg=field)
    if name == "predict_graph":
        _, eager = runs["predict"]
        for g, e in zip(ranks, eager):
            assert g["coords"] == e["coords"]
            for field, want in g["replays"][0].items():
                np.testing.assert_array_equal(want, e["detections"][field], err_msg=field)


def test_engine_graphs_on_a_space_mesh_answer_as_the_eager_space_engine(runs):
    """Every process captures the batch-1 graph in its warm-up (frame
    broadcasts, slab, predict with its halos and gathers, pose gather);
    process 0 serves the three frames by replay, the others follow by
    replay; the poses are the eager space engine's bit for bit, and the
    predict's collectives by kind the same."""
    _, eager = runs["engine"]
    _, graphed = runs["engine_graph"]
    leader = next(r for r in graphed if "poses" in r)
    want = next(r for r in eager if "poses" in r)
    assert [r["graphs"] for r in graphed] == [[1]] * 4 and leader["eager_batches"] == 0
    assert sorted(r.get("served", 0) for r in graphed) == [0, 3, 3, 3]
    for got, w in zip(leader["poses"], want["poses"]):
        for a, b in zip(got, w):
            np.testing.assert_array_equal(a, b)
    for g, e in zip(graphed, eager):  # the heartbeats ("engine") depend on the host's timing
        assert _without(g["collectives"], "engine") == _without(e["collectives"], "engine", "replicate")
        assert g["collectives"]["halo"] > 0


def test_a_graphed_fit_on_a_space_mesh_validates_on_process_0s_space_group(runs):
    """``Trainer.fit`` at data 2 x space 2 through the stand-in graphs (the
    step's graph and ``EvalForward``, as a card graphs them on an NCCL space
    mesh), one validation: the two ranks of process 0's space group validate
    (one capture each, the predict's halos and gathers, the same scalars),
    every rank holds process 0's metric and names its best checkpoint, and
    process 0 alone logs and writes checkpoints."""
    _, ranks = runs["fit_graph"]
    validators = [r for r in ranks if r["validated"] is not None]
    assert sorted(r["coords"] for r in validators) == [[0, 0, 0], [0, 0, 1]]
    assert [r["graphed"] for r in ranks] == [True] * 4
    assert [r["captures"] for r in ranks] == [int(r["validated"] is not None) for r in ranks]
    first, second = (r["validated"] for r in validators)
    assert first == second and {"halo", "gather"} <= set(first["collectives"])
    metric = first["scalars"]["mixed_point_distance_mean_mm"]
    assert np.isfinite(metric) and [r["metric"] for r in ranks] == [metric] * 4
    assert len({r["best"] for r in ranks}) == 1 and ranks[0]["best"]
    (main,) = [r for r in ranks if r["process_rank"] == 0]
    assert main["logged"] > 0 and any("last" in f for f in main["files"])
    assert [(r["logged"], r["files"]) for r in ranks if r is not main] == [(0, [])] * 3


# ---------------------------------------------------------------------------
# the space probe of chip_smoke.py, on a one-rank gloo group
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def probe_steps(states):
    """Two eager steps of ``chip_smoke.probe_space_mesh`` (data 1 x space 2 at
    space rank 0, the other rank mirrored) from the artifact's state, on a
    one-rank gloo group of this process."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{ranks_mod.free_port()}", world_size=1, rank=0)
    try:
        job = _job("step", [1, 1, 2], 4, 2, states["artifact"], probe=True)
        return [ranks_mod.spatial_job(job) for _ in range(2)]
    finally:
        dist.destroy_process_group()


def test_the_space_probe_makes_the_collectives_of_rank_0_of_a_space_two_step(runs, probe_steps):
    _, ranks = runs["step_model2_space2"]
    (zero,) = [r for r in ranks if r["coords"] == [0, 0, 0]]
    want = _without(zero["collectives"], "replicate")
    assert {"halo", "halo_backward", "gather", "gather_backward", "space_sum", "bn", "grads"} <= set(want)
    assert "metrics" not in want  # a data axis of one makes none
    assert _without(probe_steps[0]["collectives"], "replicate") == want


def test_two_eager_space_probe_steps_from_one_state_are_bit_equal_and_finite(probe_steps):
    a, b = probe_steps
    assert a["metrics"] == b["metrics"] and all(np.isfinite(v) for v in a["metrics"].values())
    assert a["digest"] == b["digest"]
    for key, value in a["state"].items():
        assert np.all(np.isfinite(value)), key
    for key, value in a["grads"].items():
        np.testing.assert_array_equal(b["grads"][key], value, err_msg=key)
