"""What every cell shares: the cell's files, caches, the device, the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration in ``benchmark/configs/<config>.json``, its traffic in
``benchmark/traffic/<traffic>.json`` (whose ``kind`` names the runner,
``harness/<kind>.py``), and each per-layer metric in
``benchmark/metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from typing import Any, Dict, List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "hmd_ego_pose_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str, bench: Optional[Dict] = None) -> Dict:
    """The cell ``name`` with its configuration and traffic read in."""
    bench = bench or benchmark()
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    return {"workload": work, "config": load_json(os.path.join(ROOT, conf["file"])),
            "traffic": load_json(os.path.join(BENCH, "traffic", work["traffic"] + ".json"))}


def metrics_for(bench: Dict, work: Dict) -> Dict[str, List[Dict]]:
    """The end-to-end and per-layer metric entries this cell reports."""
    def reported(entry, e2e_names):
        if "workloads" in entry:
            return work["name"] in entry["workloads"]
        return entry.get("moves") in e2e_names if "moves" in entry else True

    e2e = [m for m in bench["end_to_end"] if reported(m, ())]
    names = {m["name"] for m in e2e}
    return {"end_to_end": e2e, "per_layer": [m for m in bench["per_layer"] if reported(m, names)]}


def metric_reader(name: str):
    """The module ``benchmark/metrics/<name>.py``."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def set_cache_dirs() -> None:
    """Kernel build caches at fixed paths inside the checkout."""
    cache = os.path.join(BENCH, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is one the harness must not load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def work_dir(name: str) -> str:
    """A fresh directory under the run's ``TMPDIR`` for this process."""
    import tempfile

    return tempfile.mkdtemp(prefix=f"bench-{name}-")


def device_block(chips: int, peak_bytes: int, trace=None) -> Dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
           "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        out["busy_s"] = trace.busy_s
        out["window_s"] = trace.window_s
    return out


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def emit(result: Dict, checks: Dict[str, Dict[str, float]]) -> None:
    """Each compared number beside its limit, last on stderr and last in
    the result line, which is the last line of stdout."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(_finite(line), allow_nan=False), flush=True)


def _finite(obj):
    """``obj`` with each infinite or NaN float written as a string ("inf"),
    so that the line stays strict JSON when an answer never came."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj
