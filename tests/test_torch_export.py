"""``cli export`` of the port against the JAX package's, on the CPU at 128 px.

Both packages export the shipped artifact (phi-0, 128 px, float32,
``hand_relative`` from its sidecar) with ``--quantize-int8``, once per
module: the port with ``--device cpu`` (restore, BN fold, ``torch.export``,
save, load and verify, then ``weights_fp32.npz`` and ``weights_int8.npz``),
the JAX package through its own ``cli export`` (StableHLO).  Each CLI calls
its package's ``export_inference`` and ``load_and_verify`` on the params it
restored from the same file, so the files below hold ``export_inference``
of the port to the JAX package's:

* the seeded input and the meta JSON byte-equal;
* the golden outputs within 1e-4 of each output's largest |value| (the floor
  of the card's tolerance, ``scripts/make_export_reference.py``; the gap is
  ~2e-6 at 256 px);
* both weight files equal member by member (name, order, dtype, shape,
  values), and with equal canonical digests.  Their bytes differ: 40
  members of the JAX package's files inherit the Fortran order of the
  shipped file's own leaves, and the port writes C order.
"""

import contextlib
import filecmp
import io
import json
import os

import numpy as np
import pytest
import torch

from hmd_ego_pose_tpu import cli as jax_cli
from hmd_ego_pose_tpu_torch import cli
from hmd_ego_pose_tpu_torch.config import ModelConfig
from hmd_ego_pose_tpu_torch.export import pt2, reference
from hmd_ego_pose_tpu_torch.models.hmd_ego_pose import HMDEgoPose, init_weights
from hmd_ego_pose_tpu_torch.models.weights import to_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "trained", "syn1000_phi0_576ep_handrel_int8.npz")
ARGS = ["export", "--ckpt", ARTIFACT, "--quantize-int8", "--img-size", "128"]
NAME = "hmd_ego_pose"
GOLDEN_TOL_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers at once: torch's CPU kernels take two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    with contextlib.redirect_stdout(io.StringIO()) as port_out:
        result = cli.main([*ARGS, "--out-dir", port_dir, "--device", "cpu"])
    with contextlib.redirect_stdout(io.StringIO()) as jax_out:
        jax_cli.main([*ARGS, "--out-dir", jax_dir])
    return {"port": port_dir, "jax": jax_dir, "port_printed": port_out.getvalue().splitlines(),
            "jax_printed": jax_out.getvalue().splitlines(), "result": result}


def _npz(path):
    with np.load(path) as data:
        return [(k, data[k]) for k in data.files]


def test_cli_export_writes_every_file_and_prints_the_three_lines(exports):
    port_dir = exports["port"]
    assert sorted(os.listdir(port_dir)) == sorted(
        [f"{NAME}.pt2", f"{NAME}_input.npy", f"{NAME}_golden.npz", f"{NAME}_meta.json",
         "weights_fp32.npz", "weights_fp32.json", "weights_int8.npz", "weights_int8.json"])
    got, want = exports["port_printed"], exports["jax_printed"]
    assert len(got) == len(want) == 3
    assert got[0] == want[0] and got[0].startswith("[cli] checkpoint metadata records hand_relative=True")
    assert got[1] == f"exported + verified torch.export artifact in {port_dir}"
    assert want[1] == f"exported + verified StableHLO artifact in {exports['jax']}"
    assert got[2] == want[2] and got[2].startswith("int8 checkpoint: ")
    assert exports["result"] == port_dir
    sizes = {n: os.path.getsize(os.path.join(port_dir, f"weights_{n}.npz")) for n in ("fp32", "int8")}
    assert sizes["int8"] < sizes["fp32"] / 3


def test_export_input_and_meta_byte_equal_to_jax(exports):
    for suffix in ("_input.npy", "_meta.json"):
        assert filecmp.cmp(os.path.join(exports["port"], NAME + suffix),
                           os.path.join(exports["jax"], NAME + suffix), shallow=False)
    with open(os.path.join(exports["port"], f"{NAME}_meta.json")) as f:
        assert json.load(f) == {"image_size": 128, "phi": 0, "batch_size": 1, "outputs": list(pt2.OUTPUTS)}


def test_export_goldens_within_tolerance_of_jax(exports):
    got = dict(_npz(os.path.join(exports["port"], f"{NAME}_golden.npz")))
    want = dict(_npz(os.path.join(exports["jax"], f"{NAME}_golden.npz")))
    assert list(got) == list(want) == list(pt2.OUTPUTS)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert np.abs(g - w).max() <= GOLDEN_TOL_REL * np.abs(w).max(), key
    # the card's check, on its own terms: the summary of the port's goldens against the JAX package's
    anchors = reference.sample_anchors(want["classification"])
    worst = reference.gaps(got, reference.summarize(want, anchors), anchors)
    assert max(worst.values()) <= GOLDEN_TOL_REL, worst


@pytest.mark.parametrize("name", ["weights_fp32", "weights_int8"])
def test_cli_export_weight_files_equal_jax_member_by_member(exports, name):
    got = _npz(os.path.join(exports["port"], name + ".npz"))
    want = _npz(os.path.join(exports["jax"], name + ".npz"))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert reference.content_digest(os.path.join(exports["port"], name + ".npz")) == reference.content_digest(
        os.path.join(exports["jax"], name + ".npz"))
    if name == "weights_int8":
        assert got[0][0] == "__format__" and sum(k.endswith("/int8") for k, _ in got) == 137


def test_int8_export_gives_back_the_shipped_int8_values(exports):
    """The shipped artifact is a fixed point of quantize: dequantized and quantized
    again, every stored int8 value and scale comes back bit for bit."""
    shipped = {k: v for k, v in _npz(ARTIFACT) if k.endswith(("/int8", "/scales"))}
    got = {k: v for k, v in _npz(os.path.join(exports["port"], "weights_int8.npz")) if k in shipped}
    assert len(got) == len(shipped) == 2 * 137
    for k, v in shipped.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_load_and_verify_refuses_an_output_off_its_golden(tmp_path):
    """A small program saved under the export's file names: it verifies against its
    own outputs and raises once one golden value moves by 1e-3."""

    class Tiny(torch.nn.Module):
        def forward(self, images):
            return {"a": images.mean(dim=(1, 2)), "b": images.amax(dim=-1)}

    x = np.random.RandomState(0).uniform(-1, 1, (1, 4, 4, 3)).astype(np.float32)
    torch.export.save(torch.export.export(Tiny(), (torch.from_numpy(x),)), str(tmp_path / "t.pt2"))
    np.save(tmp_path / "t_input.npy", x)
    golden = {k: v.numpy() for k, v in Tiny()(torch.from_numpy(x)).items()}
    np.savez(tmp_path / "t_golden.npz", **golden)
    assert pt2.load_and_verify(str(tmp_path), "t", device="cpu")
    golden["b"][0, 1, 2] += 1e-3
    np.savez(tmp_path / "t_golden.npz", **golden)
    with pytest.raises(AssertionError):
        pt2.load_and_verify(str(tmp_path), "t", device="cpu")


def test_cli_export_without_ckpt_exports_the_seeded_init(monkeypatch, tmp_path, capsys):
    """Without ``--ckpt`` the port exports ``init_weights`` with torch's generator at
    seed 0 (the JAX package's ``init(0)`` draws from JAX's generator instead)."""
    seen = {}

    def fake_export(params, bn_state, config, out_dir, **kw):
        seen.update(params=params, bn_state=bn_state, config=config, device=kw["device"])
        return out_dir

    monkeypatch.setattr(pt2, "export_inference", fake_export)
    monkeypatch.setattr(pt2, "load_and_verify", lambda *a, **kw: True)
    cli.main(["export", "--img-size", "128", "--out-dir", str(tmp_path), "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == [f"exported + verified torch.export artifact in {tmp_path}"]
    cfg = ModelConfig(phi=0, image_size=128)
    assert seen["config"] == cfg and seen["device"] == torch.device("cpu")
    want_p, want_b = to_jax_params(init_weights(HMDEgoPose(cfg), torch.Generator().manual_seed(0)).state_dict(), cfg)
    for got, want in ((seen["params"], want_p), (seen["bn_state"], want_b)):
        got_flat, want_flat = _leaves(got), _leaves(want)
        assert [k for k, _ in got_flat] == [k for k, _ in want_flat]
        for (_, g), (_, w) in zip(got_flat, want_flat):
            np.testing.assert_array_equal(g, w)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}{i}/")]
    return [(prefix, np.asarray(tree))]


def test_cli_export_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["export", "--img-size", "128", "--out-dir", str(tmp_path)])
