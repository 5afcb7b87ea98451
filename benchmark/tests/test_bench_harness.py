"""The benchmark's harness on the CPU: its files are found by name, its
arithmetic equals counts written out by hand, it imports no JAX, and a
new cell or metric needs new files only.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from benchmark import flops, harness, trace
from benchmark.kernels import k1
from benchmark.tests import tiny

BENCH = harness.BENCH_DIR
SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_file_is_found_by_name():
    for cfg in SPEC["configs"]:
        loaded = harness.load_json("configs", cfg["name"])
        assert Path(harness.ROOT / cfg["file"]) == BENCH / "configs" / \
            f"{cfg['name']}.json"
        assert loaded["reduced"] == cfg["reduced"] == []
    for cell in SPEC["workloads"]:
        wl = harness.load_json("workloads", cell["name"])
        assert wl["config"] == cell["config"]
        assert wl["mode"] == cell["traffic"]
        assert wl["chips"] == cell["chips"] == 1
        assert callable(harness.load_module("modes", wl["mode"]).run)
        assert set(wl["control"]) <= {"model", "params"}
    for m in SPEC["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    assert k1.NAME.search("mhsa_short_fwd_tc_kernel")


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"]
             + SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:   # the cell reports what it moves
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for cell in SPEC["workloads"]:
        reported = harness.cell_metrics(SPEC, cell["name"], "end_to_end")
        assert len(reported) >= 2 and harness.cell_metrics(
            SPEC, cell["name"], "per_layer")
        assert 0 < len(cell["why"]) <= 200
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_interval_union_and_gaps_by_hand():
    intervals = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 7.0)]
    # [0, 2] + [3, 4] + [6, 7]
    assert trace.union_seconds(intervals) == pytest.approx(4.0)
    assert trace.idle_gaps(intervals, 0.0, 8.0) == [(4.0, 6.0), (2.0, 3.0),
                                                    (7.0, 8.0)]


def test_train_flops_of_the_flagship_by_hand():
    cfg = harness.load_json("configs", "flagship")["model"]
    # One 224 x 224 frame through the ViT: 49 patches of 1,024 pixels into
    # 512, then 6 blocks over 50 tokens: q, k, v (512 -> 1,024 each),
    # scores and weights x v (16 heads of 64), out (1,024 -> 512), the
    # MLP (512 -> 512 -> 512).
    patch = 2 * 49 * 1024 * 512
    block = (3 * 2 * 50 * 512 * 1024 + 2 * 2 * 16 * 50 * 50 * 64
             + 2 * 50 * 1024 * 512 + 2 * 2 * 50 * 512 * 512)
    frame = patch + 6 * block
    assert frame == 1_685_684_224
    # B = 8, T = 191: 1,528 frames and 8 CAD images (the same ViT).
    vit = (1528 + 8) * frame
    rows = 8 * 191
    embeds = (2 * rows * 512 * 1024 + 2 * 8 * 512 * 1024
              + 2 * rows * 7 * 1024 + 2 * rows * 2048 * 1024)
    causal = 191 * 192 // 2
    band = sum(min(q + 1, 10) for q in range(191))
    attn = lambda pairs: 2 * 2 * 8 * 4 * pairs * 256  # noqa: E731
    layer = (4 * 2 * rows * 1024 * 1024 + attn(causal)     # self-attention
             + 4 * 2 * rows * 1024 * 1024 + attn(band)     # cross-attention
             + 2 * 2 * rows * 1024 * 1024)                 # feed-forward
    heads = 2 * rows * 1024 * 6005
    forward = vit + embeds + 8 * layer + heads
    assert flops.forward_flops(cfg, 8, 191) == forward
    assert flops.train_step_flops(cfg, 8, 191) == 3 * forward
    assert 8.5e12 < 3 * forward < 8.8e12


def test_k1_bound_of_the_train_step_by_hand():
    cfg = harness.load_json("configs", "flagship")["model"]
    calls = k1.train_step_calls(cfg, 8, 191)
    assert len(calls) == 24       # 6 blocks x (fwd, bwd) x 2 encoders
    tensor = 1528 * 50 * 16 * 64 * 2
    fwd = 4 * tensor / 3.35e12    # bytes bound the 1,528-frame calls
    bwd = 7 * tensor / 3.35e12
    small = 8 * 50 * 16 * 64 * 2
    want = 6 * (fwd + bwd) + 6 * (4 * small + 7 * small) / 3.35e12
    assert k1.train_step_bound_s(cfg, 8, 191) == pytest.approx(want)
    assert fwd == pytest.approx(0.187e-3, rel=0.01)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path
        if "reference" in path.parts:
            assert "videocad_tpu_torch" not in tops, path


def test_forbidden_modules_compares_whole_names():
    saved = dict(sys.modules)
    try:
        sys.modules["videocad_tpu_torch_probe"] = types.ModuleType("x")
        assert harness.forbidden_modules() == []
        sys.modules["videocad_tpu.probe"] = types.ModuleType("y")
        assert harness.forbidden_modules() == ["videocad_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_run_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for root in (harness.ROOT, tmp_path):
        if root == tmp_path:     # BENCHMARK.json and the paths alone
            shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(BENCH, tmp_path / "benchmark",
                            ignore=shutil.ignore_patterns("__pycache__"))
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "flagship.train", "--seed", "3", "--seconds", "1"],
            cwd=root, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_new_cell_and_metric_need_new_files_only(tmp_path):
    """A dummy cell, mode and metric added as files to a copy are run and
    read by the copy's harness with no other edit."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = dict(SPEC)
    bench = tmp_path / "benchmark"
    (bench / "workloads" / "flagship.dummy.json").write_text(json.dumps(
        {"config": "flagship", "mode": "dummy", "chips": 1, "why": "test",
         "params": {"n": 3}, "limits": {"n_gap": 0.5}, "control": {}}))
    (bench / "modes" / "dummy.py").write_text(
        "def run(ctx):\n"
        "    ctx.open_window()\n"
        "    return {'attempted': ctx.params['n'], 'failed': 0,\n"
        "            'memory_peak_bytes': 0, 'e2e': {'dummy_rate': 2.5},\n"
        "            'data': {'n': ctx.params['n']},\n"
        "            'numbers': {'n_gap': 0.0, 'n_other': 9.0}}\n")
    (bench / "metrics" / "dummy_count.py").write_text(
        "def read(data):\n    return data['n'] * 2.0\n")
    spec["workloads"] = SPEC["workloads"] + [
        {"name": "flagship.dummy", "config": "flagship", "traffic": "dummy",
         "chips": 1, "why": "test"}]
    spec["end_to_end"] = SPEC["end_to_end"] + [
        {"name": "dummy_rate", "unit": "1/s", "better": "higher",
         "bound": 0.05, "source": "host_clock",
         "workloads": ["flagship.dummy"]}]
    spec["per_layer"] = SPEC["per_layer"] + [
        {"name": "dummy_count", "unit": "1", "better": "higher",
         "source": "program_counter", "layer": "dummy", "moves":
         "dummy_rate", "workloads": ["flagship.dummy"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    module_spec = importlib.util.spec_from_file_location(
        "copied_harness", bench / "harness.py")
    copied = importlib.util.module_from_spec(module_spec)
    sys.modules["copied_harness"] = copied     # dataclasses look it up
    try:
        module_spec.loader.exec_module(copied)
    finally:
        del sys.modules["copied_harness"]
    assert copied.BENCH_DIR == bench
    for traced in (False, True):
        ctx = copied.make_context("flagship.dummy", 1, 1.0, traced,
                                  torch.device("cpu"), time.perf_counter())
        result = copied.run_cell(ctx, copied.benchmark_spec(tmp_path))
        assert result["correct"] and result["attempted"] == 3
        want = ({"dummy_count": 6.0} if traced
                else {"dummy_rate": 2.5, "setup_s": result["metrics"][
                    "setup_s"]["value"]})
        assert {k: v["value"] for k, v in result["metrics"].items()} == want


def test_a_result_names_every_end_to_end_metric_of_its_cell():
    result = tiny.run("flagship.rollout", seconds=0.2)
    assert set(result["metrics"]) == {"rollout_actions_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
