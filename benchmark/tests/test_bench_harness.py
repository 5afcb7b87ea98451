"""The benchmark's harness on the CPU: its files are found by name and
keep the contract, its arithmetic equals counts written out by hand, it
imports no JAX, the port's span recorder is on only in a traced span, and
a new cell, metric, or model family with a cut configuration needs new
files only.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import Dict, List

import pytest
import torch

from benchmark import flops, harness, trace
from benchmark.kernels import k1
from benchmark.tests import tiny

BENCH = harness.BENCH_DIR
SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# Keys that are widths, which a configuration never cuts.
WIDTH = re.compile(r"(_dim|_rank)$|hidden_size|intermediate_size|head_dim"
                   r"|latent|expansion|experts_per_tok|state_size|proj")
FAMILY = ("build_program", "make_weights", "reference_trainer",
          "train_step_flops", "k1_calls")


def contract_problems(h, spec: Dict) -> List[str]:
    """What breaks the contract between ``spec`` (a ``BENCHMARK.json``) and
    the files harness module ``h`` finds by name: a configuration's file,
    its ``reduced`` (equal in both files, each key a key of ``model`` that
    is no width, with a published value that differs from the one held),
    its family; a cell's file, mode and ``chips`` (1 or 4, equal in both
    files; at most a quarter of the cells, or one, on 4); each per-layer
    metric's reader."""
    out = []
    for cfg in spec["configs"]:
        name = cfg["name"]
        if h.ROOT / cfg["file"] != h.BENCH_DIR / "configs" / f"{name}.json":
            out.append(f"{name}: its file is not found by its name")
        loaded = h.load_json("configs", name)
        reduced, published = loaded["reduced"], loaded.get("published", {})
        if reduced != cfg["reduced"]:
            out.append(f"{name}: reduced {reduced} in its file and "
                       f"{cfg['reduced']} in BENCHMARK.json")
        if set(published) != set(reduced):
            out.append(f"{name}: published values of {sorted(published)} "
                       f"for reduced {reduced}")
        for key in reduced:
            if key not in loaded["model"]:
                out.append(f"{name}: reduced {key} is no key of its model")
            elif published.get(key) == loaded["model"][key]:
                out.append(f"{name}: reduced {key} holds its published value")
            if WIDTH.search(key):
                out.append(f"{name}: reduced {key} is a width")
        fam = h.load_module("families", loaded.get("family",
                                                   "videocadformer"))
        out += [f"{name}: its family lacks {fn}" for fn in FAMILY
                if not callable(getattr(fam, fn, None))]
    cells = spec["workloads"]
    for cell in cells:
        name = cell["name"]
        wl = h.load_json("workloads", name)
        if (wl["config"], wl["mode"]) != (cell["config"], cell["traffic"]):
            out.append(f"{name}: config or mode differs between the files")
        if cell["chips"] not in (1, 4) or wl["chips"] != cell["chips"]:
            out.append(f"{name}: chips {wl['chips']} in its file and "
                       f"{cell['chips']} in BENCHMARK.json")
        if not callable(getattr(h.load_module("modes", wl["mode"]), "run",
                                None)):
            out.append(f"{name}: mode {wl['mode']} has no run")
        if not set(wl["control"]) <= {"model", "params"}:
            out.append(f"{name}: control overrides {sorted(wl['control'])}")
    fours = sum(cell["chips"] == 4 for cell in cells)
    if fours > max(1, len(cells) // 4):
        out.append(f"{fours} of {len(cells)} cells take 4 chips")
    out += [f"{m['name']}: no reader" for m in spec["per_layer"]
            if not callable(getattr(h.load_module("metrics", m["name"]),
                                    "read", None))]
    return out


def test_every_file_is_found_by_name():
    assert contract_problems(harness, SPEC) == []
    assert harness.load_json("configs", "flagship")["reduced"] == []
    assert k1.NAME.search("mhsa_short_fwd_tc_kernel")


def _copy(tmp_path: Path) -> Path:
    """benchmark/ and BENCHMARK.json copied under ``tmp_path``."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    return tmp_path / "benchmark"


def _copied_harness(bench: Path):
    """The harness module of the copy at ``bench``, finding its files."""
    module_spec = importlib.util.spec_from_file_location(
        "copied_harness", bench / "harness.py")
    copied = importlib.util.module_from_spec(module_spec)
    sys.modules["copied_harness"] = copied     # dataclasses look it up
    try:
        module_spec.loader.exec_module(copied)
    finally:
        del sys.modules["copied_harness"]
    assert copied.BENCH_DIR == bench
    return copied


def _edit_json(path: Path, edit) -> None:
    data = json.loads(path.read_text())
    edit(data)
    path.write_text(json.dumps(data))


def _cut_decoder(bench: Path, spec: Dict, key: str = "num_decoder_layers",
                 in_spec: bool = True) -> None:
    """The flagship's ``key`` cut to 4, 8 published."""
    def edit(cfg):
        cfg["reduced"], cfg["published"] = [key], {key: 8}
        cfg["model"]["num_decoder_layers"] = 4
    _edit_json(bench / "configs" / "flagship.json", edit)
    if in_spec:
        spec["configs"][0]["reduced"] = [key]


def _chips(bench: Path, spec: Dict, chips: List[int]) -> None:
    for cell, n in zip(spec["workloads"], chips):
        cell["chips"] = n
        _edit_json(bench / "workloads" / f"{cell['name']}.json",
                   lambda wl, n=n: wl.update(chips=n))


CONTRACT_CASES = {
    "a cut configuration": (_cut_decoder, None),
    "one cell of three on four chips": (
        lambda b, s: _chips(b, s, [4, 1, 1]), None),
    "reduced only in the configuration's file": (
        lambda b, s: _cut_decoder(b, s, in_spec=False), "BENCHMARK.json"),
    "reduced names a key the model lacks": (
        lambda b, s: _cut_decoder(b, s, key="num_layers"), "no key"),
    "reduced names a width": (
        lambda b, s: _cut_decoder(b, s, key="hidden_size"), "a width"),
    "a cell on two chips": (
        lambda b, s: _chips(b, s, [1, 2, 1]), "chips 2"),
    "two cells of three on four chips": (
        lambda b, s: _chips(b, s, [4, 4, 1]), "2 of 3 cells"),
}


@pytest.mark.parametrize("case", sorted(CONTRACT_CASES))
def test_the_contract_takes_cuts_and_four_chips_within_its_rules(
        tmp_path, case):
    bench = _copy(tmp_path)
    spec = json.loads(json.dumps(SPEC))
    edit, refused = CONTRACT_CASES[case]
    edit(bench, spec)
    problems = contract_problems(_copied_harness(bench), spec)
    if refused is None:
        assert problems == []
    else:
        assert any(refused in p for p in problems), problems


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
    calls = harness.load_module("families", "videocadformer").k1_calls(
        cfg, 8, 191)
    assert len(calls) == 24       # 6 blocks x (fwd, bwd) x 2 encoders
    tensor = 1528 * 50 * 16 * 64 * 2
    fwd = 4 * tensor / 3.35e12    # bytes bound the 1,528-frame calls
    bwd = 7 * tensor / 3.35e12
    small = 8 * 50 * 16 * 64 * 2
    want = 6 * (fwd + bwd) + 6 * (4 * small + 7 * small) / 3.35e12
    assert k1.calls_bound_s(calls) == pytest.approx(want)
    assert fwd == pytest.approx(0.187e-3, rel=0.01)


def test_the_flagship_family_gives_the_flagship_numbers():
    """``families/videocadformer.py`` against the numbers the harness
    gave the flagship before the families: the FLOPs and K1's bound of a
    train step, bit for bit, and the first weights of a fixed seed."""
    fam = harness.load_module("families", "videocadformer")
    cfg = harness.load_json("configs", "flagship")["model"]
    assert fam.train_step_flops(cfg, 8, 191) == 8_633_086_574_592
    assert fam.train_step_flops(cfg, 8, 191) == flops.train_step_flops(
        cfg, 8, 191)
    assert k1.calls_bound_s(fam.k1_calls(cfg, 8, 191)) == \
        0.0030987768358208957
    ctx = types.SimpleNamespace(model_cfg=cfg, seed=3000000201,
                                device=torch.device("cpu"))
    weights = fam.make_weights(ctx)
    assert len(weights) == 397
    assert sum(w.numel() for w in weights.values()) == 126_963_573
    first = {"state_encoder.cls_token": [-0.05121534317731857,
                                         0.02252306416630745,
                                         0.035246726125478745],
             "decoder.layers_0.cross_attn.value.bias": [
                 -0.000782014278229326, 0.022973472252488136,
                 0.045055851340293884],
             "predict_params.bias": [0.002537816297262907,
                                     0.018488842993974686,
                                     -0.0030185868963599205]}
    for name, values in first.items():
        assert weights[name].flatten()[:3].tolist() == values
    assert float(sum(w.double().sum() for w in weights.values())) == \
        41177.935634956564


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
    bench = _copy(tmp_path)
    spec = dict(SPEC)
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
    copied = _copied_harness(bench)
    for traced in (False, True):
        ctx = copied.make_context("flagship.dummy", 1, 1.0, traced,
                                  torch.device("cpu"), time.perf_counter())
        result = copied.run_cell(ctx, copied.benchmark_spec(tmp_path))
        assert result["correct"] and result["attempted"] == 3
        want = ({"dummy_count": 6.0} if traced
                else {"dummy_rate": 2.5, "setup_s": result["metrics"][
                    "setup_s"]["value"]})
        assert {k: v["value"] for k, v in result["metrics"].items()} == want


# A second model family, as a later PR would add one: a tiny MLP policy
# over the training cells' batch contract, its plain reference, a
# configuration of it cut in depth, a train cell and a span reader.
SECOND_FAMILY = {
    "reference/mlp_policy.py": '''
"""A tiny MLP policy in plain PyTorch, float32: per step, the frame's mean
grey level and the step's action go through ReLU layers to the command
and parameter logits."""
import math

import torch

from benchmark.reference.vocab import NUM_BINS, NUM_COMMANDS, NUM_PARAMS

OUT = NUM_COMMANDS + NUM_PARAMS * NUM_BINS


def param_spec(cfg):
    out, fan = [], 8
    for i in range(cfg["num_layers"]):
        out += [(f"layers_{i}.weight", (cfg["hidden_size"], fan)),
                (f"layers_{i}.bias", (cfg["hidden_size"],))]
        fan = cfg["hidden_size"]
    return out + [("head.weight", (OUT, fan)), ("head.bias", (OUT,))]


def make_weights(cfg, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return {name: torch.randn(shape, generator=gen, device=device)
            / math.sqrt(shape[-1]) for name, shape in param_spec(cfg)}


def forward(p, cfg, frames, actions, cad_image, drop):
    x = torch.cat([frames.float().mean(dim=(2, 3, 4))[..., None] / 255.0,
                   actions], dim=-1)
    for i in range(cfg["num_layers"]):
        x = torch.relu(x @ p[f"layers_{i}.weight"].T + p[f"layers_{i}.bias"])
    y = x @ p["head.weight"].T + p["head.bias"]
    return y[..., :NUM_COMMANDS], y[..., NUM_COMMANDS:].unflatten(
        -1, (NUM_PARAMS, NUM_BINS))
''',
    "families/mlp_policy.py": '''
"""The MLP policy: its program is an nn.Module driven by the port's train
state and step; its reference is reference/mlp_policy.py (no fp8 path:
no control is read of it)."""
import torch
from torch import nn

from benchmark.reference import mlp_policy as ref
from benchmark.reference.train import Trainer


class Policy(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.device, fan = device, 8
        self.num_layers = cfg["num_layers"]
        for i in range(self.num_layers):
            setattr(self, f"layers_{i}",
                    nn.Linear(fan, cfg["hidden_size"], device=device))
            fan = cfg["hidden_size"]
        self.head = nn.Linear(fan, ref.OUT, device=device)

    def forward(self, inputs, rng=None):
        frames = inputs["frames"].float()
        x = torch.cat([frames.mean(dim=(2, 3, 4))[..., None] / 255.0,
                       inputs["actions"]], dim=-1)
        for i in range(self.num_layers):
            x = torch.relu(getattr(self, f"layers_{i}")(x))
        y = self.head(x)
        return y[..., :5], y[..., 5:].unflatten(-1, (6, -1))


def build_program(ctx, weights):
    from videocad_tpu_torch.train import (REFERENCE_CMD_WEIGHTS, LossConfig,
                                          create_train_state,
                                          make_train_step)
    model = Policy(ctx.model_cfg, ctx.device)
    model.load_state_dict(weights, strict=True)
    state = create_train_state(dict(model.named_parameters()),
                               {"lr": ctx.params["lr"]})
    return model, state, make_train_step(model,
                                         LossConfig(REFERENCE_CMD_WEIGHTS))


def make_weights(ctx):
    return ref.make_weights(ctx.model_cfg, ctx.seed, ctx.device)


def reference_trainer(ctx, weights, low_precision=False):
    return Trainer(ctx.model_cfg, weights, ctx.params["lr"], low_precision,
                   forward=ref.forward)


def train_step_flops(cfg, batch, t):
    widths = [8] + [cfg["hidden_size"]] * cfg["num_layers"] + [ref.OUT]
    return 3 * 2 * batch * t * sum(a * b for a, b in zip(widths,
                                                          widths[1:]))


def k1_calls(cfg, batch, t):
    return []
''',
    "metrics/forward_spans.mlp.py": '''
def read(data):
    trace = data.get("trace")
    if not trace or "step.forward" not in trace["spans"]:
        return None
    return float(trace["spans"]["step.forward"]["count"])
''',
    "configs/mlp_tiny.json": json.dumps({
        "source": "a test's stand-in", "family": "mlp_policy",
        "reduced": ["num_layers"], "published": {"num_layers": 3},
        "deployment": "the layers left out would lie on two more chips",
        "model": {"hidden_size": 16, "num_layers": 1, "image_size": 16}}),
    "workloads/mlp_tiny.train.json": json.dumps({
        "config": "mlp_tiny", "mode": "train", "chips": 1, "why": "test",
        "params": {"batch": 2, "seq_len": 6, "batches": 3, "lr": 1e-3,
                   "warmup_steps": 1, "trace_seconds": 1.0},
        "limits": {"loss_gap": 1e-5, "grad_gap": 1e-4, "update_gap": 1e-3,
                   "grad_gap_median": 1e-4},
        "control": {}}),
}

RUN_THE_CELL = '''
import json, time, torch, torch.profiler
from benchmark import harness
from benchmark.tests.test_bench_harness import contract_problems
from videocad_tpu_torch.utils import trace
torch.set_num_threads(1)   # tiny ops: threads only contend
spec, out = harness.benchmark_spec(), {"bench": str(harness.BENCH_DIR)}
out["problems"] = contract_problems(harness, spec)
for traced in (False, True):
    ctx = harness.make_context("mlp_tiny.train", 11, 3.0, traced,
                               torch.device("cpu"), time.perf_counter())
    result = harness.run_cell(ctx, spec)
    out[str(traced)] = {"correct": result["correct"],
                        "checks": result["checks"],
                        "metrics": {k: v["value"] for k, v in
                                    result["metrics"].items()},
                        "recording": trace._recording}
print(json.dumps(out))
'''


def test_a_second_family_with_a_cut_configuration_needs_new_files_only(
        tmp_path):
    """A second model family, its cut configuration, a train cell of it
    and a span reader, added to a copy as new files only, run traced and
    untraced through the copy's own harness on the CPU, and the copy keeps
    the contract."""
    bench = _copy(tmp_path)
    for name, text in SECOND_FAMILY.items():
        (bench / name).write_text(text.lstrip())
    spec = json.loads(json.dumps(SPEC))
    cell = "mlp_tiny.train"
    spec["configs"].append({
        "name": "mlp_tiny", "source": "https://example.org/mlp",
        "file": "benchmark/configs/mlp_tiny.json", "reduced": ["num_layers"],
        "why": "a second family"})
    spec["workloads"].append({"name": cell, "config": "mlp_tiny",
                              "traffic": "train", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("train_frames_per_s", "train_mfu",
                         "fwd_host_ms.train"):
            m["workloads"].append(cell)
    spec["per_layer"].append({
        "name": "forward_spans.mlp", "unit": "1", "better": "lower",
        "source": "program_span", "layer": "model step",
        "moves": "train_frames_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    # In a process of its own, where ``benchmark`` is the copy.
    out = subprocess.run(
        [sys.executable, "-c", RUN_THE_CELL], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(harness.ROOT)),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bench"] == str(bench) and got["problems"] == []
    untraced, traced = got["False"], got["True"]
    for result in (untraced, traced):
        assert result["correct"], result["checks"]
        assert not result["recording"]
    assert set(untraced["metrics"]) == {"train_frames_per_s", "setup_s"}
    assert set(traced["metrics"]) == {"train_mfu", "fwd_host_ms.train",
                                      "forward_spans.mlp"}
    assert traced["metrics"]["forward_spans.mlp"] >= 1
    assert traced["metrics"]["fwd_host_ms.train"] > 0


def test_the_recorder_is_on_only_inside_a_traced_span():
    """``Tracer`` turns the port's span recorder on at ``begin()`` and off
    at ``stop()``; untraced, never. (No card here: spans alone.)"""
    from videocad_tpu_torch.utils import trace as recorder

    seen = []

    def work():
        seen.append(recorder._recording)
        with recorder.span("unit", len(seen)):
            pass

    for enabled in (False, True):
        seen.clear()
        tracer = trace.Tracer(enabled, lambda: None)
        tracer.start()
        work()
        tracer.begin()
        work()
        work()
        tracer.stop(2)
        tracer.label(work)
        summary = tracer.summary()
        assert recorder._recording is False
        if enabled:
            assert seen == [False, True, True, False]
            assert summary["span_units"] == {"unit": 2}
            assert summary["spans"]["unit"]["count"] == 2
            assert summary["idle_by_span"] == {}    # no device trace
        else:
            assert seen == [False] * 4 and summary is None
    recorder.drain()


def test_a_result_names_every_end_to_end_metric_of_its_cell():
    result = tiny.run("flagship.rollout", seconds=0.2)
    assert set(result["metrics"]) == {"rollout_actions_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert result["correct"], result["checks"]


def test_the_disk_cell_reads_its_rate_per_layer():
    """The disk cell's end-to-end metrics are its peak and set-up; its
    frame rate is read per layer, over the part after the tracer."""
    result = tiny.run("flagship.train-disk", seconds=0.5)
    assert set(result["metrics"]) == {"train_peak_gb", "setup_s"}
    traced = tiny.run("flagship.train-disk", seconds=0.5, trace=True)
    assert traced["metrics"]["train_frames_per_s.disk"]["value"] > 0
    assert traced["correct"], traced["checks"]
    read = harness.load_module("metrics", "train_frames_per_s.disk").read
    assert read({"rate_frames": 300, "rate_window_s": 2.0}) == 150.0
    assert read({"rate_frames": 0, "rate_window_s": 2.0}) is None
