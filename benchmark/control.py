"""Readings of the numbers that decide ``correct``, on the card at a cell's
own size, for setting their limits: the program as the cell runs it, the
control (the program with its lower-precision path switched on: the
cell's ``control`` overrides), or the program with a fault planted
(``benchmark/faults.py``), over several seeds in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--control] [--fault <name>]

Prints one JSON line a seed: the checks' numbers, ``correct`` under the
cell's present limits, and the end-to-end metrics. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import faults, harness

    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA card", file=sys.stderr)
        return 3
    spec = harness.benchmark_spec(ROOT)
    overrides = (harness.load_json("workloads", args.workload)["control"]
                 if args.control else {})
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.make_context(args.workload, seed, args.seconds, False,
                                   device, time.perf_counter(), overrides)
        with faults.planted(args.fault):
            result = harness.run_cell(ctx, spec)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          "correct": result["correct"],
                          "checks": result["checks"],
                          "numbers": result["numbers"],
                          "metrics": result["metrics"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
