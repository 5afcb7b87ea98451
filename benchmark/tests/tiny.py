"""A cell's run at a size the CPU holds: the configuration's widths cut to
a few units and float32 (so that a sound run reads round-off alone), the
traffic cut to a few rows and steps, the harness's look for a card
skipped."""

from __future__ import annotations

import time

import torch

from benchmark import harness

TINY_MODEL = {"image_size": 64, "vit_dim": 32, "vit_depth": 2,
              "vit_heads": 2, "vit_head_dim": 16, "vit_mlp_dim": 32,
              "hidden_size": 64, "dim_feedforward": 64,
              "num_decoder_layers": 2, "window_size": 3,
              "dtype": "float32"}
TINY_PARAMS = {
    "flagship.train": {"batch": 2, "seq_len": 8, "trace_seconds": 0.0},
    "flagship.train-disk": {"batch": 2, "sequences": 4, "aliases": 2,
                            "min_len": 5, "max_len": 8,
                            "trace_seconds": 0.0},
    "flagship.rollout": {"seq_len": 6},
}


def run(cell: str, seed: int = 7, seconds: float = 0.5, trace: bool = False,
        model=None, params=None) -> dict:
    overrides = {"model": dict(TINY_MODEL, **(model or {})),
                 "params": dict(TINY_PARAMS.get(cell, {}), **(params or {}))}
    ctx = harness.make_context(cell, seed, seconds, trace,
                               torch.device("cpu"), time.perf_counter(),
                               overrides)
    return harness.run_cell(ctx, harness.benchmark_spec())
