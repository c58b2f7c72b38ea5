"""The port's reference-checkpoint loading and ``cli parity`` against the JAX package's.

* ``strip_prefixes`` on every wrapper the reference's loaders strip: equal
  to the JAX package's.
* ``load_torch_state_dict`` against ``convert_torch_state_dict`` on seeded
  reference-named state_dicts (tensors or arrays, every prefix, with
  ``num_batches_tracked``, with iterative-subnet keys, with keys missing,
  with a bogus key, with a wrong shape): the same missing and unused keys,
  the same refusals strict and lenient, and the loaded model's state_dict
  equal, bit for bit, to ``from_jax_params`` of the JAX package's converted
  trees.
* ``cli parity --device cpu`` against the JAX package's ``cli parity`` on a
  seeded state_dict saved with ``torch.save`` (phi-0, 128 px), strict with a
  ``module.`` prefix, lenient on an ``iter_steps=1`` state_dict (its
  iterative keys unused), and on an NCHW ``--input``: the same
  ``converted`` line and row names, every statistic and head value within
  ``chip_smoke.PARITY_TOLERANCE_REL`` (1e-4) of the JAX package's at the
  layer's scale (``chip_smoke.hold_parity``, the card's check).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from hmd_ego_pose_tpu import cli as jax_cli
from hmd_ego_pose_tpu.config import ModelConfig as JaxModelConfig
from hmd_ego_pose_tpu.models import hmd_ego_pose as jax_model
from hmd_ego_pose_tpu.models import weights as jax_weights
from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.config import ModelConfig
from hmd_ego_pose_tpu_torch.models import weights
from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose

SIZE = 128


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state_dicts():
    """Seeded reference-named state_dicts (numpy) at iter_steps 0 and 1: conv
    kernels uniform at He scale, BN scales near 1, variances positive, every
    other value small."""
    out = {}
    for it in (0, 1):
        rng = np.random.RandomState(it)
        sd = {}
        for k, v in HMDEgoPose(ModelConfig(phi=0, image_size=SIZE, iter_steps=it)).state_dict().items():
            u = rng.uniform(-1.0, 1.0, size=tuple(v.shape))
            if v.ndim == 4:
                u = u * np.sqrt(6.0 / np.prod(v.shape[1:]))
            elif k.endswith(("running_var", "bn.weight")) or ("_bn" in k and k.endswith(".weight")):
                u = 1.0 + 0.2 * u
            else:
                u = 0.1 * u
            sd[k] = u.astype(np.float32)
        out[it] = sd
    return out


def test_strip_prefixes_matches_jax():
    sd = {"module.a": 1, "model.b": 2, "model.module.c": 3, "module.model.d": 4, "e": 5,
          "module.module.f": 6, "xmodule.g": 7}
    assert weights.strip_prefixes(sd) == jax_weights.strip_prefixes(sd)
    assert set(weights.strip_prefixes(sd)) == {"a", "b", "c", "d", "e", "module.f", "xmodule.g"}
    assert weights.PREFIXES == ("model.module.", "module.model.", "model.", "module.")


@functools.lru_cache(maxsize=None)
def _template(it):
    """A host template of the JAX layout for ``convert_torch_state_dict``, which
    reads only its structure and shapes and never writes it."""
    cfg = ModelConfig(phi=0, image_size=SIZE, iter_steps=it)
    return weights.to_jax_params(HMDEgoPose(cfg).state_dict(), cfg)


def _jax_convert(sd, it, strict):
    cfg = JaxModelConfig(phi=0, image_size=SIZE, iter_steps=it)
    return jax_weights.convert_torch_state_dict(sd, *_template(it), cfg, strict=strict)


CASES = {
    "module_tensors": lambda sd: {"module." + k: torch.from_numpy(v) for k, v in sd.items()},
    "model_module_arrays": lambda sd: {"model.module." + k: v for k, v in sd.items()},
    "num_batches_tracked": lambda sd: {**sd, **{k.replace("running_var", "num_batches_tracked"): np.asarray(7)
                                                for k in sd if k.endswith("running_var")}},
    "missing": lambda sd: {k: v for i, (k, v) in enumerate(sd.items()) if i % 97},
    "bogus": lambda sd: {**sd, "bogus.key": np.zeros(3, np.float32)},
}


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "lenient"])
@pytest.mark.parametrize("case,sd_iter,model_iter", [(c, 0, 0) for c in sorted(CASES)]
                         + [("module_tensors", 1, 1), ("missing", 1, 1), ("module_tensors", 1, 0)])
def test_load_matches_jax_conversion(state_dicts, case, strict, sd_iter, model_iter):
    sd = CASES[case](state_dicts[sd_iter])
    model = HMDEgoPose(ModelConfig(phi=0, image_size=SIZE, iter_steps=model_iter))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        p, b, want = _jax_convert(sd, model_iter, strict)
    except ValueError as e:
        with pytest.raises(ValueError, match="conversion mismatch"):
            weights.load_torch_state_dict(model, sd, strict=strict)
        assert "conversion mismatch" in str(e)
        assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())  # untouched
        return
    got = weights.load_torch_state_dict(model, sd, strict=strict)
    assert got == want
    expected = weights.from_jax_params(p, b, model.config)
    for k, v in model.state_dict().items():
        if k in got["missing"]:
            assert torch.equal(v, before[k]), k  # the model's own value stays
        else:
            assert torch.equal(v, expected[k]), k


def test_shape_mismatch_raises_like_jax(state_dicts):
    sd = dict(state_dicts[0])
    key = "regressor.header.pointwise_conv.conv.weight"
    sd[key] = np.zeros((1,) + sd[key].shape[1:], np.float32)
    for strict in (True, False):
        with pytest.raises(ValueError, match="shape mismatch"):
            _jax_convert(sd, 0, strict)
        with pytest.raises(ValueError, match=f"shape mismatch for {key}"):
            weights.load_torch_state_dict(HMDEgoPose(ModelConfig(phi=0, image_size=SIZE)), sd, strict=strict)


def _jax_parity(sd, capsys, argv, x):
    """The JAX CLI's printed text, and its numbers at full precision as ``cmd_parity`` computes them."""
    jax_cli.main(argv)
    printed = capsys.readouterr().out
    cfg = JaxModelConfig(phi=0, image_size=SIZE)
    p, b, _ = _jax_convert(sd, 0, "--lenient" not in argv)
    capture = {}
    out, _ = jax_model.apply(p, b, jax.numpy.asarray(x), cfg, capture=capture)
    stats = {n: [float(np.asarray(a).mean()), float(np.asarray(a).std()), float(np.abs(np.asarray(a)).max())]
             for n, a in capture.items()}
    heads = {f: [float(v) for v in np.asarray(getattr(out, f))[0, 0, :6]] for f in cli.PARITY_FIELDS}
    return printed, {"stats": stats, "heads": heads}


def _rows(printed):
    return [line.split()[0] for line in printed.splitlines() if line.startswith("  ")]


@pytest.mark.parametrize("sd_iter,prefix,lenient,nchw", [(0, "module.", False, False), (1, "model.", True, False),
                                                         (0, "", False, True)])
def test_cli_parity_matches_jax(state_dicts, tmp_path, capsys, sd_iter, prefix, lenient, nchw):
    path = str(tmp_path / "reference.pth")
    torch.save({prefix + k: torch.from_numpy(v) for k, v in state_dicts[sd_iter].items()}, path)
    argv = ["parity", "--torch-ckpt", path, "--img-size", str(SIZE)] + (["--lenient"] if lenient else [])
    x = np.random.RandomState(0).uniform(-1, 1, size=(1, SIZE, SIZE, 3)).astype(np.float32)
    if nchw:
        x = np.random.RandomState(5).normal(size=(1, SIZE, SIZE, 3)).astype(np.float32)
        np.save(str(tmp_path / "input.npy"), x.transpose(0, 3, 1, 2))
        argv += ["--input", str(tmp_path / "input.npy")]
    want_printed, want = _jax_parity(state_dicts[sd_iter] if not prefix else
                                     {prefix + k: v for k, v in state_dicts[sd_iter].items()}, capsys, argv, x)
    got = cli.main(argv + ["--device", "cpu"])
    got_printed = capsys.readouterr().out
    assert got_printed.splitlines()[0] == want_printed.splitlines()[0]  # "converted: N missing, M unused keys"
    assert _rows(got_printed) == _rows(want_printed)
    assert len(got["stats"]) == 3 + 3 * 5 and len(got["report"]["unused"]) == (75 if sd_iter else 0)
    held = chip_smoke.hold_parity(got, want)
    assert held["values"] == 3 * len(got["stats"]) + 4 + 1 + 3 + 3 + 6  # the heads' first six (or fewer) values


def test_cli_parity_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["parity", "--img-size", str(SIZE)])
