"""The split of a traced window's device idle time by the program's spans
(``benchmark/spans.py``), on intervals and spans written out by hand.

    python -m pytest benchmark/tests/test_bench_spans.py -q
"""

from __future__ import annotations

from typing import NamedTuple

import pytest

from benchmark import spans, trace

MAIN, WORKER = 1, 2
S = 1_000_000_000          # a second in ns


class Span(NamedTuple):    # the fields of the port's recorded span
    name: str
    start_ns: int
    end_ns: int
    thread: int = MAIN


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
