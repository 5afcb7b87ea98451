"""The port's span recorder (``videocad_tpu_torch/utils/trace.py``) and the
spans the program records: a train step's phases, the data pipeline's
assembly, wait and copy, and the operator's ``trace.json``, which holds
them beside the profiler's events.

The recorder is held by its properties: nesting, parents and keys per
thread, spans closed out of order, nothing recorded while off, ``drain``
clearing, one clock with
``torch.profiler``, and a disabled span's cost. The program's spans are
held on tiny CPU runs: one span of each phase a unit of work, with
matching keys, and a train step that computes the same bits with the
recorder on as with it off.
"""

import json
import os
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tests.helpers import TINY_CONFIG
from videocad_tpu_torch.data.dataset import VideoCADDataset, load_split_ids
from videocad_tpu_torch.data.pipeline import DataPipeline, device_prefetch
from videocad_tpu_torch.data.synthetic import (synthetic_batch_feed,
                                               write_synthetic_dataset)
from videocad_tpu_torch.models import create_model
from videocad_tpu_torch.train import objective as port_objective
from videocad_tpu_torch.train import state as port_state
from videocad_tpu_torch.train import steps as port_steps
from videocad_tpu_torch.train.trainer import Trainer
from videocad_tpu_torch.utils import trace

LOSS = port_objective.LossConfig(port_objective.REFERENCE_CMD_WEIGHTS)


@pytest.fixture(autouse=True)
def clean_recorder():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _inside(inner, outer):
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


# ---- the recorder ----

def test_spans_nest_with_parents_keys_and_threads():
    trace.enable()
    seen = {}

    def worker():
        with trace.span("w", key=7):
            with trace.span("w.inner", key=7):
                pass
        seen["thread"] = threading.get_ident()

    with trace.span("a", key=1):
        with trace.span("a.b", key=1):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
        with trace.span("a.c", key=2):
            pass
    assert not t.is_alive()
    spans = _by_name(trace.drain())
    assert sorted(spans) == ["a", "a.b", "a.c", "w", "w.inner"]
    a, b, c = spans["a"][0], spans["a.b"][0], spans["a.c"][0]
    w, wi = spans["w"][0], spans["w.inner"][0]
    assert (a.parent, b.parent, c.parent) == (None, "a", "a")
    # A thread's first span has no parent, though another thread has
    # spans open.
    assert (w.parent, wi.parent) == (None, "w")
    assert (a.key, b.key, c.key, w.key) == (1, 1, 2, 7)
    assert a.thread == b.thread == c.thread == threading.get_ident()
    assert w.thread == wi.thread == seen["thread"] != a.thread
    assert _inside(b, a) and _inside(c, a) and _inside(wi, w)
    assert _inside(w, b)
    assert b.end_ns <= c.start_ns


def test_a_span_closed_out_of_order_leaves_the_others_open():
    """A span closed before one opened after it (as a span held across a
    generator's ``yield`` would be) takes itself off its thread's stack,
    and not the span above it."""
    trace.enable()
    outer, inner = trace.span("outer"), trace.span("inner")
    outer.__enter__()
    inner.__enter__()
    outer.__exit__(None, None, None)
    with trace.span("under_inner"):
        pass
    inner.__exit__(None, None, None)
    with trace.span("alone"):
        pass
    spans = {s.name: s for s in trace.drain()}
    assert spans["outer"].parent is None
    assert spans["inner"].parent == "outer"
    assert spans["under_inner"].parent == "inner"
    assert spans["alone"].parent is None


def test_a_disabled_recorder_records_nothing():
    first, second = trace.span("x", 1), trace.span("y")
    assert first is second            # one shared no-op object
    with first:
        with second:
            pass
    assert trace.drain() == []
    trace.enable()
    trace.disable()
    with trace.span("x"):
        pass
    assert trace.drain() == []


def test_drain_returns_and_clears():
    trace.enable()
    for i in range(3):
        with trace.span("s", i):
            pass
    got = trace.drain()
    assert [s.key for s in got] == [0, 1, 2]
    assert trace.drain() == []
    with trace.span("s", 3):
        pass
    assert [s.key for s in trace.drain()] == [3]


def test_a_span_open_when_recording_stops_still_ends_into_the_list():
    trace.enable()
    with trace.span("open"):
        trace.disable()
        with trace.span("after"):
            pass
    assert [s.name for s in trace.drain()] == ["open"]


def test_spans_share_the_profilers_clock():
    """A ``record_function`` event made inside a span lies inside it: the
    span's ``time.time_ns()`` and kineto's ``start_ns()`` are one clock."""
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            time.sleep(0.002)
            with record_function("probe"):
                time.sleep(0.002)
            time.sleep(0.002)
    outer, = trace.drain()
    probe, = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "probe"]
    start = probe.start_ns()
    assert outer.start_ns <= start
    assert start + probe.duration_ns() <= outer.end_ns


def test_a_disabled_span_costs_under_a_microsecond():
    span, n = trace.span, 20_000
    best = float("inf")
    for _ in range(7):
        t0 = time.perf_counter_ns()
        for i in range(n):
            with span("step.forward", i):
                pass
        best = min(best, (time.perf_counter_ns() - t0) / n)
    assert best < 1000, f"{best:.0f} ns a disabled span"


# ---- the program's spans ----

def _train_once(record: bool):
    model = create_model(TINY_CONFIG,
                         generator=torch.Generator().manual_seed(0))
    state = port_state.create_train_state(dict(model.named_parameters()),
                                          {"lr": 1e-3})
    step = port_steps.make_train_step(model, LOSS, noise=True)
    batch = {k: torch.from_numpy(v).float() if k == "actions"
             else torch.from_numpy(v)
             for k, v in synthetic_batch_feed(2, 8, image_size=32,
                                              seed=3).items()}
    if record:
        trace.enable()
    state, loss, _ = step(state, batch, 5)
    trace.disable()
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return loss, params, trace.drain()


def test_a_train_step_records_its_phases_and_computes_the_same_bits():
    loss_off, params_off, none = _train_once(record=False)
    loss_on, params_on, spans = _train_once(record=True)
    assert none == []
    assert torch.equal(loss_on, loss_off)
    assert params_on.keys() == params_off.keys()
    for k in params_on:
        assert torch.equal(params_on[k], params_off[k]), k
    spans = _by_name(spans)
    assert sorted(spans) == ["step", "step.backward", "step.forward",
                             "step.optimizer"]
    assert all(len(v) == 1 for v in spans.values())
    step = spans["step"][0]
    assert (step.key, step.parent) == (0, None)
    phases = [spans[n][0] for n in ("step.forward", "step.backward",
                                    "step.optimizer")]
    for phase in phases:
        assert (phase.key, phase.parent) == (0, "step")
        assert _inside(phase, step)
    assert phases[0].end_ns <= phases[1].start_ns
    assert phases[1].end_ns <= phases[2].start_ns


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trace_store"))
    write_synthetic_dataset(root, num_sequences=8, min_len=5, max_len=8,
                            image_size=32, seed=0, split_path=os.path.join(
                                root, "dataset_split.json"))
    return root


def test_a_pipeline_epoch_records_assembly_wait_and_copy_per_batch(store):
    pipe = DataPipeline(VideoCADDataset(store), batch_size=2, buckets=(8,),
                        seed=0, num_workers=2)
    trace.enable()
    batches = list(device_prefetch(pipe.epoch(0), "cpu", size=2))
    trace.disable()
    spans = _by_name(trace.drain())
    assert len(batches) == len(pipe) == 4
    assert sorted(spans) == ["data.assemble", "data.copy", "data.wait"]
    for name in spans:
        assert sorted(s.key for s in spans[name]) == [0, 1, 2, 3], name
    main = threading.get_ident()
    assert all(s.thread != main for s in spans["data.assemble"])
    assert all(s.thread == main for s in spans["data.wait"]
               + spans["data.copy"])
    # A batch is assembled before it is waited for and copied.
    assemble = {s.key: s for s in spans["data.assemble"]}
    wait = {s.key: s for s in spans["data.wait"]}
    copy = {s.key: s for s in spans["data.copy"]}
    for k in range(4):
        assert assemble[k].end_ns <= wait[k].end_ns <= copy[k].start_ns


def test_profiling_writes_the_spans_of_the_profiled_steps(store, tmp_path):
    splits = load_split_ids(os.path.join(store, "dataset_split.json"))
    pipes = [DataPipeline(VideoCADDataset(store, ids=splits[split]),
                          batch_size=2, buckets=(8,), seed=0,
                          shuffle=split == "train")
             for split in ("train", "val", "test")]
    model = create_model(dict(TINY_CONFIG, num_decoder_layers=1),
                         generator=torch.Generator().manual_seed(0))
    config = {"lr": 1e-3, "save_frequency": 100, "val_frequency": 100,
              "experiment_name": "exp", "early_stopping_enabled": False,
              "enable_profiling": True,
              "checkpoint_dir": str(tmp_path / "ckpt")}
    trainer = Trainer(model, *pipes, config, LOSS,
                      log_dir=str(tmp_path / "logs"))
    trainer.train(epochs=1)
    out = os.path.join(trainer.logger.dir, "profile_traces", "epoch0")
    assert os.listdir(out) == ["trace.json"]     # one file, one timeline
    with open(os.path.join(out, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    profiled = [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("name", "").startswith("ProfilerStep#")]
    assert len(profiled) == len(pipes[0])
    lo, hi = min(p[0] for p in profiled), max(p[1] for p in profiled)
    events = [e for e in events if e.get("pid") == "spans"]
    names = [e["name"] for e in events]
    for name in ("step", "step.forward", "step.backward", "step.optimizer",
                 "data.wait", "data.copy"):
        assert names.count(name) == len(profiled), name
    # On the same time base: every span lies inside the profiled steps
    # (a microsecond of rounding either way).
    for e in events:
        assert lo - 1 <= e["ts"] and e["ts"] + e["dur"] <= hi + 1, e
    assert trace.drain() == []      # the recorder is off and empty again
    with trace.span("after"):
        pass
    assert trace.drain() == []
