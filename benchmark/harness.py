"""The benchmark's machinery: finding configurations, cells, modes,
metric readers and kernel counts by name, the run's context, and the
result line.

Everything that belongs to one configuration, cell, traffic mode, metric
or kernel is a file of its own, found by the name ``BENCHMARK.json`` or a
cell gives it:

  benchmark/configs/<config>.json     the model configuration as run
  benchmark/workloads/<cell>.json     config, mode, parameters, and the
                                      limits of the numbers compared
  benchmark/modes/<mode>.py           run(ctx) -> the mode's raw result
  benchmark/families/<family>.py      what a training mode takes from the
                                      model: program, weights, reference,
                                      work a step (videocadformer.py says)
  benchmark/metrics/<metric>.py       read(data) -> value or None
  benchmark/kernels/<kernel>.py       kernel names, per-call work

A configuration file holds ``source``, ``model`` (the keys as run),
``family`` (absent: ``videocadformer``), ``assumed`` (sizes the source
does not give) and ``reduced``: the keys of ``model`` changed from the
source, equal to the configuration's ``reduced`` in ``BENCHMARK.json``.
Each key in ``reduced`` has its published value under ``published``
(``{"num_hidden_layers": 27}`` beside ``model``'s 13 held), and
``deployment`` says what the cut stands for (the chips that share a
layer). A cell's ``chips`` is 1 or 4, equal in its file and in
``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Whole top-level module names that no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "videocad_tpu")


def load_json(kind: str, name: str) -> Dict:
    with open(BENCH_DIR / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}._{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark_spec(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(spec: Dict, cell: str, section: str) -> List[Dict]:
    """The metrics of ``section`` that cell reports: those that list it
    under ``workloads``, or have no such list."""
    return [m for m in spec[section]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def cache_env(root: Path = ROOT) -> Dict[str, str]:
    """Build and kernel caches at fixed paths inside the checkout, and no
    JAX behind any library."""
    build = root / "build"
    return {"TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
            "TRITON_CACHE_DIR": str(build / "triton_cache"),
            "USE_FLAX": "0", "USE_JAX": "0", "USE_TF": "0"}


@dataclasses.dataclass
class Context:
    """What a mode gets: the cell, its configuration and parameters, the
    run's arguments, the device, and the clocks."""
    cell: str
    model_cfg: Dict[str, Any]
    params: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float                       # process start, perf_counter
    family: str = "videocadformer"       # benchmark/families/<family>.py
    window_start: Optional[float] = None
    marks: List = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        """Note that set-up step ``name`` has ended (set-up's breakdown)."""
        self.marks.append((name, time.perf_counter()))

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open_window(self) -> float:
        """Mark the window's start (set-up ends here); reset the peak."""
        import torch
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.window_start = time.perf_counter()
        return self.window_start

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def make_context(cell: str, seed: int, seconds: float, trace: bool, device,
                 t_start: float, overrides: Optional[Dict] = None
                 ) -> Context:
    overrides = overrides or {}
    wl = load_json("workloads", cell)
    config = load_json("configs", wl["config"])
    model_cfg = dict(config["model"], **overrides.get("model", {}))
    params = dict(wl["params"], **overrides.get("params", {}))
    limits = dict(wl.get("limits", {}), **overrides.get("limits", {}))
    return Context(cell, model_cfg, params, limits, seed, seconds, trace,
                   device, t_start,
                   family=config.get("family", "videocadformer"))


def run_cell(ctx: Context, spec: Dict) -> Dict:
    """Run the cell's mode and build the result line (without the device
    block, which the caller adds)."""
    wl = load_json("workloads", ctx.cell)
    out = load_module("modes", wl["mode"]).run(ctx)
    data = dict(out.get("data", {}), setup_s=ctx.window_start - ctx.t_start)
    metrics = {}
    if ctx.trace:
        for m in cell_metrics(spec, ctx.cell, "per_layer"):
            value = load_module("metrics", m["name"]).read(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(out["e2e"], setup_s=data["setup_s"])
        for m in cell_metrics(spec, ctx.cell, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    numbers = out["numbers"]
    checks = {name: check(numbers[name], limit)
              for name, limit in ctx.limits.items()}
    correct = bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    trace = data.get("trace")
    if ctx.trace and trace is not None:
        result["busy_s"] = trace["busy_s"]
        result["window_s"] = trace["window_s"]
        result["breakdown"] = trace["breakdown"]
    result["numbers"] = numbers      # all of them, for the readings
    steps, last = [], ctx.t_start
    for name, at in ctx.marks:
        steps.append((name, at - last))
        last = at
    result["setup_steps"] = steps
    result["checks"] = checks
    return result


def check(value: float, limit: float) -> Dict[str, float]:
    return {"value": float(value), "limit": float(limit)}
