"""The split of a traced window's device idle time by the program's spans
(``benchmark/spans.py``), the summary of a traced span
(``benchmark/trace.py:Tracer.summary``) and the span readers
(``benchmark/metrics/``), on intervals and spans written out by hand.

    python -m pytest benchmark/tests/test_bench_spans.py -q
"""

from __future__ import annotations

from typing import NamedTuple

import pytest

from benchmark import harness, spans, trace

MAIN, WORKER = 1, 2
S = 1_000_000_000          # a second in ns


class Span(NamedTuple):    # the fields of the port's recorded span
    name: str
    start_ns: int
    end_ns: int
    thread: int = MAIN
    key: int = 0


def test_innermost_wins_and_stretches_merge():
    got = spans.innermost_stretches([
        ("step", 0.0, 10.0), ("step.forward", 1.0, 4.0),
        ("step.backward", 4.0, 8.0), ("inner", 5.0, 6.0),
        ("step", 12.0, 13.0), ("step", 13.0, 14.0)])
    assert got == [(0.0, 1.0, "step"), (1.0, 4.0, "step.forward"),
                   (4.0, 5.0, "step.backward"), (5.0, 6.0, "inner"),
                   (6.0, 8.0, "step.backward"), (8.0, 10.0, "step"),
                   (12.0, 14.0, "step")]


def test_two_spans_that_begin_together_give_the_shorter():
    got = spans.innermost_stretches([("outer", 0.0, 4.0),
                                     ("inner", 0.0, 1.0)])
    assert got == [(0.0, 1.0, "inner"), (1.0, 4.0, "outer")]


def test_idle_is_split_by_overlap_not_by_the_span_at_the_gaps_start():
    stretches = [(0.0, 2.0, "a"), (2.0, 5.0, "b"), (6.0, 7.0, "c")]
    # One gap runs over a, b and the hole before c; another lies past c.
    got = spans.split_idle([(9.0, 10.0), (1.0, 6.5)], stretches)
    assert got == pytest.approx({"a": 1.0, "b": 3.0, "c": 0.5,
                                 "outside": 2.0})


def test_idle_by_span_leaves_worker_spans_out_and_keeps_outside():
    intervals = [(0.0, 1.0), (3.0, 4.0), (8.0, 9.0)]    # device busy
    gaps = trace.idle_gaps(intervals, 0.0, 10.0)  # 1-3, 4-8, 9-10
    recorded = [
        Span("step", 0, 7 * S), Span("step.forward", 0, 2 * S),
        Span("step.backward", 2 * S, 5 * S),
        Span("step.optimizer", 5 * S, 6 * S),
        # A worker's assembly covers every gap, and counts for none.
        Span("data.assemble", 0, 10 * S, WORKER)]
    got = spans.idle_by_span(gaps, recorded, MAIN)
    assert got == pytest.approx({"step.forward": 1.0, "step.backward": 2.0,
                                 "step.optimizer": 1.0, "step": 1.0,
                                 "outside": 2.0})
    assert sum(got.values()) == pytest.approx(7.0)
    # With no spans at all (a port that records none), all of it is
    # outside.
    assert spans.idle_by_span(gaps, [], MAIN) == pytest.approx(
        {"outside": 7.0})


def test_span_totals_count_the_spans_inside_the_window():
    recorded = [Span("step", 0, 2 * S), Span("step", 3 * S, 4 * S),
                Span("step", 5 * S, 9 * S),          # ends past the window
                Span("data.copy", S, 2 * S, WORKER)]
    got = spans.span_totals(recorded, 0, 6 * S)
    assert got == {"step": {"count": 2, "s": pytest.approx(3.0)},
                   "data.copy": {"count": 1, "s": pytest.approx(1.0)}}


def test_span_units_count_the_distinct_keys_inside_the_window():
    recorded = [Span("step", 0, S, key=1), Span("step", S, 2 * S, key=2),
                Span("data.assemble", 0, S, WORKER, key=7),
                Span("data.assemble", S, 2 * S, WORKER, key=7),
                Span("step", 5 * S, 9 * S, key=3)]   # ends past the window
    assert spans.span_units(recorded, 0, 6 * S) == {"step": 2,
                                                     "data.assemble": 1}


def _traced(ms: float) -> int:
    return round(ms * 1e6)


# Two train steps inside a 10 s traced span, each of a forward, a
# backward and an optimizer span, with the batches' wait and copy between
# them on the main thread and the assembly on a worker thread. Seconds.
STEPS = [(1, 0.0, 4.5, 2.0, 4.0), (2, 5.0, 9.5, 6.0, 8.0)]
RECORDED = []
for key, lo, hi, fwd_end, bwd_end in STEPS:
    RECORDED += [Span("step", _traced(lo * 1e3), _traced(hi * 1e3), key=key),
                 Span("step.forward", _traced(lo * 1e3),
                      _traced(fwd_end * 1e3), key=key),
                 Span("step.backward", _traced(fwd_end * 1e3),
                      _traced(bwd_end * 1e3), key=key),
                 Span("step.optimizer", _traced(bwd_end * 1e3),
                      _traced(hi * 1e3), key=key)]
RECORDED += [
    Span("data.wait", _traced(4500), _traced(4600), key=0),
    Span("data.copy", _traced(4600), _traced(4900), key=0),
    Span("data.wait", _traced(9500), _traced(9800), key=1),
    Span("data.copy", _traced(9800), _traced(9900), key=1),
    Span("data.assemble", 0, 3 * S, WORKER, key=0),
    Span("data.assemble", 3 * S, 5 * S, WORKER, key=1),
    Span("data.assemble", 9 * S, 11 * S, WORKER, key=2)]   # past the end
# The device is busy over these; idle over 1-2, 3.5-5, 5.5-6, 8.2-10.
BUSY = [(0.0, 1.0), (2.0, 3.5), (5.0, 5.5), (6.0, 8.2)]


def _summary(recorded, busy, device: bool = True):
    """What ``Tracer.summary`` gives for a traced span of 10 s over two
    steps, with ``recorded`` spans and the device busy over ``busy``."""
    tracer = trace.Tracer(True, lambda: None)
    tracer.window_s, tracer.units = 10.0, 2
    tracer.events = ([("kernel", True, lo, hi) for lo, hi in busy]
                     if device else [])
    tracer.spans = recorded
    tracer._lo_ns, tracer._hi_ns, tracer._thread = 0, 10 * S, MAIN
    return tracer.summary()


READINGS = {                       # ms a step or a batch, by hand
    "fwd_host_ms.train": (2.0 + 1.0) / 2 * 1e3,
    "bwd_host_ms.train": (2.0 + 2.0) / 2 * 1e3,
    "optim_host_ms.train": (0.5 + 1.5) / 2 * 1e3,
    # Idle under the optimizer: 4.0-4.5 of the gap 3.5-5, 8.2-9.5 of 8.2-10.
    "optim_idle_ms.train": (0.5 + 1.3) / 2 * 1e3,
    "assemble_ms.train": (3.0 + 2.0) / 2 * 1e3,
    "assembly_wait_ms.train": (0.1 + 0.3) / 2 * 1e3,
    "pin_copy_ms.train": (0.3 + 0.1) / 2 * 1e3,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_a_span_reader_by_hand(name):
    read = harness.load_module("metrics", name).read
    summary = _summary(RECORDED, BUSY)
    assert read({"trace": summary}) == pytest.approx(READINGS[name])
    # A port that records no spans, or a run with no trace: nothing.
    assert read({"trace": _summary([], BUSY)}) is None
    assert read({}) is None
    if name == "optim_idle_ms.train":      # idle needs a device trace
        assert read({"trace": _summary(RECORDED, BUSY, False)}) is None
    else:
        assert read({"trace": _summary(RECORDED, BUSY, False)}) == \
            pytest.approx(READINGS[name])


def test_the_step_phases_add_up_to_the_step():
    summary = _summary(RECORDED, BUSY)
    phases = sum(harness.load_module("metrics", f"{n}_host_ms.train").read(
        {"trace": summary}) for n in ("fwd", "bwd", "optim"))
    assert phases == pytest.approx(spans.mean_ms(summary, "step"))
    # Gap 1-2 under a forward; 3.5-5: backward 0.5, optimizer 0.5, wait
    # 0.1, copy 0.3, outside 0.1; 5.5-6 under a forward; 8.2-10:
    # optimizer 1.3, wait 0.3, copy 0.1, outside 0.1.
    assert summary["idle_by_span"] == pytest.approx(
        {"step.forward": 1.5, "step.backward": 0.5, "step.optimizer": 1.8,
         "data.wait": 0.4, "data.copy": 0.4, "outside": 0.2})
