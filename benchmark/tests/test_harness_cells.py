"""Every part of ``BENCHMARK.json`` is found by name, and each per-layer
metric's reader declares what its entry says."""

import os
import re

import pytest

from harness import common

BENCH = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_names_units_and_limits():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(work):
    cell = common.cell(work["name"], BENCH)
    assert cell["config"]["name"] == work["config"]
    assert os.path.isfile(os.path.join(common.BENCH, "harness", cell["traffic"]["kind"] + ".py"))
    limits = common.load_json(os.path.join(common.BENCH, "reference", "limits", work["config"] + ".json"))
    assert cell["traffic"]["kind"] in limits
    reported = common.metrics_for(BENCH, work)
    assert [m["name"] for m in reported["end_to_end"] if m["name"] != "setup_s"]
    assert reported["per_layer"]
    e2e = {m["name"] for m in reported["end_to_end"]}
    assert all(m["moves"] in e2e for m in reported["per_layer"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_metric_has_its_reader(metric):
    reader = common.metric_reader(metric["name"])
    assert (reader.SOURCE, reader.UNIT, reader.LAYER, reader.MOVES) == (
        metric["source"], metric["unit"], metric["layer"], metric["moves"])
    assert reader.read({}) is None  # nothing to read: nothing reported


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        conf = common.load_json(os.path.join(common.ROOT, c["file"]))
        assert conf["name"] == c["name"] and conf["source"] == c["source"]


def test_the_command_alone_gives_no_result(tmp_path):
    """Beside only ``BENCHMARK.json`` and ``benchmark/`` (no program, here no
    card either) the command exits non-zero and prints no result line."""
    import shutil
    import subprocess
    import sys

    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(common.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    run = subprocess.run([sys.executable, "benchmark/run.py", "--workload", BENCH["workloads"][0]["name"],
                          "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert not any(line.startswith("{") for line in run.stdout.splitlines())
