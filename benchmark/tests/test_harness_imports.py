"""Nothing the benchmark's command runs imports JAX or the JAX package."""

import ast
import os

from harness import common

RUN_DIRS = ("harness", "reference", "metrics", "tools")


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def forbidden(names):
    return sorted({n for n in names if n in common.FORBIDDEN})


def sources():
    yield os.path.join(common.BENCH, "run.py")
    for d in RUN_DIRS:
        for dirpath, _, files in os.walk(os.path.join(common.BENCH, d)):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)


def test_no_file_the_command_runs_imports_jax_or_the_jax_package():
    found = {p: forbidden(top_level_imports(p)) for p in sources()}
    assert {p: f for p, f in found.items() if f} == {}
    assert len(found) > 20


def test_the_check_compares_whole_top_level_names():
    assert forbidden(["hmd_ego_pose_tpu_torch", "jaxtyping", "flaxen"]) == []
    assert forbidden(["hmd_ego_pose_tpu", "jax", "jaxlib", "flax"]) == ["flax", "hmd_ego_pose_tpu", "jax", "jaxlib"]


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(common.BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = set(top_level_imports(os.path.join(ref, f)))
            assert "hmd_ego_pose_tpu_torch" not in names and "harness" not in names, f


def test_the_run_checks_loaded_modules_by_whole_name(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "hmd_ego_pose_tpu_torch_fake", types.ModuleType("x"))
    assert "hmd_ego_pose_tpu_torch_fake" not in common.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax.numpy" in common.forbidden_loaded()
