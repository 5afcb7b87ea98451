"""Whole runs of each cell at a size the CPU holds, the harness's look for
a card skipped: a sound run is correct, and a run with the timed path
broken underneath (``benchmark/faults.py``) is not, under the cells' own
limits. The control, the program on its lower-precision path at the
cells' own size, needs the card (``cuda`` marker).

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import faults, harness
from benchmark.tests import tiny

# Every cell the harness holds.
CELLS = sorted(p.stem for p in
               (harness.BENCH_DIR / "workloads").glob("*.json"))
FAULTS = {"flagship.train": ("stale_state", "half_batch"),
          "flagship.train-disk": ("stale_state", "half_batch",
                                  "corrupt_batch"),
          "flagship.rollout": ("altered_token",)}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result = tiny.run(cell, seconds=0.5)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]])
def test_a_fault_under_the_timed_path_is_caught(cell, fault):
    with faults.planted(fault):
        result = tiny.run(cell, seconds=0.5)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The control at the cell's own size, on the card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size on a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", cell,
         "--seeds", "3000000201", "--seconds", "20", "--control"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert not line["correct"], line["checks"]
