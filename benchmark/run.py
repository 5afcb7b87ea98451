"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration and weights (made on the card from the
seed), warms up the shapes the cell uses, measures for ``--seconds``, checks
the window's outputs against the plain reference, and prints one JSON line:
the end-to-end metrics with ``--trace 0``, the per-layer metrics (and the
trace's busy and window seconds and its breakdown) with ``--trace 1``. The
numbers compared for ``correct`` come last in that line, under ``checks``,
and again as the last lines of standard error. It needs as many CUDA cards
as the cell asks for, and exits non-zero, printing no result, without them
or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    os.environ.update(harness.cache_env(ROOT))
    spec = harness.benchmark_spec(ROOT)
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has "
              f"{sorted(cells)}", file=sys.stderr)
        return 2

    import torch

    chips = cells[args.workload]["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found {cards}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(4)
    ctx = harness.make_context(args.workload, args.seed, args.seconds,
                               bool(args.trace), device, T_START)
    ctx.mark("imports and CUDA context")
    result = harness.run_cell(ctx, spec)
    found = harness.forbidden_modules()
    if found:
        print(f"modules that no run may load were loaded: {found}",
              file=sys.stderr)
        return 4
    checks = result.pop("checks")
    result.pop("numbers")
    print("set-up: " + ", ".join(f"{name} {sec:.2f} s" for name, sec in
                                 result.pop("setup_steps")), file=sys.stderr)
    line = {
        "correct": result["correct"], "attempted": result["attempted"],
        "failed": result["failed"], "metrics": result["metrics"],
        "device": {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": chips,
                   "memory_peak_bytes": result["memory_peak_bytes"]},
    }
    if args.trace and "busy_s" in result:
        line["device"]["busy_s"] = result["busy_s"]
        line["device"]["window_s"] = result["window_s"]
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
