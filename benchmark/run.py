"""Run one benchmark cell once and print its result as the last line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell comes from ``BENCHMARK.json``; its traffic's ``kind`` names the
runner (``harness/serve.py``, ``harness/train.py``).  With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (each read by ``metrics/<name>.py``), the device's busy
and traced seconds, and the breakdown of the profiled slice.  The run needs
a CUDA card (as many as the cell asks for), imports neither JAX nor the JAX
package, and exits non-zero without a result line otherwise.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import common  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=int, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bench = common.benchmark()
    cell = common.cell(args.workload, bench)
    chips = cell["workload"]["chips"]
    common.set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    runner = importlib.import_module("harness." + cell["traffic"]["kind"])
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace))

    found = common.forbidden_loaded()
    if found:
        print(f"loaded what the benchmark must not load: {found}", file=sys.stderr)
        return 4
    wanted = common.metrics_for(bench, cell["workload"])
    metrics = {}
    if args.trace:
        for m in wanted["per_layer"]:
            value = common.metric_reader(m["name"]).read(out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in wanted["end_to_end"]:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": common.device_block(chips, out["peak"], out["trace"] if args.trace else None)}
    if args.trace and out["trace"] is not None:
        result["breakdown"] = {"device_ops": out["trace"].device_ops(), "idle_gaps": out["trace"].idle_gaps()}
    result["power"] = common.power_limit()
    result.update(out.get("extra", {}))
    common.emit(result, out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
