"""The program's spans read against the device trace of a traced window.

The port records spans (``videocad_tpu_torch/utils/trace.py``): a phase's
name, the unit's key, its start and end on ``time.time_ns()`` (the clock of
``torch.profiler``'s events), its parent and its thread. Given the spans of
a traced window and the window's idle gaps (``trace.idle_gaps``), this
module gives:

- :func:`span_totals`: by name, the count and summed seconds of the spans
  that lie inside the window;
- :func:`span_units`: by name, the units of work those spans cover (their
  distinct keys: train steps, batches), what a per-unit mean divides by;
- :func:`mean_ms`: a span's milliseconds a unit in a traced window's
  summary, what the span readers (``benchmark/metrics/``) report;
- :func:`idle_by_span`: the window's device idle seconds, split by the
  innermost span of one thread (the main thread: workers' spans run beside
  it and do not say what the host that launches work is doing) open over
  each stretch of idle time. The split is by overlap, not by the span open
  at a gap's start; idle time under no span goes under ``"outside"``.

A span is any object with ``name``, ``key``, ``start_ns``, ``end_ns`` and
``thread``; nothing here imports the port, so a checkout whose port records
no spans reads empty totals and all its idle time ``"outside"``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

OUTSIDE = "outside"


def span_totals(spans, lo_ns: int, hi_ns: int) -> Dict[str, Dict]:
    """{name: {"count": n, "s": seconds}} of the spans inside
    [lo_ns, hi_ns]."""
    out: Dict[str, Dict] = {}
    for s in spans:
        if s.start_ns >= lo_ns and s.end_ns <= hi_ns:
            c = out.setdefault(s.name, {"count": 0, "s": 0.0})
            c["count"] += 1
            c["s"] += (s.end_ns - s.start_ns) * 1e-9
    return out


def span_units(spans, lo_ns: int, hi_ns: int) -> Dict[str, int]:
    """{name: number of distinct keys} of the spans inside [lo_ns, hi_ns]."""
    keys: Dict[str, set] = {}
    for s in spans:
        if s.start_ns >= lo_ns and s.end_ns <= hi_ns:
            keys.setdefault(s.name, set()).add(s.key)
    return {name: len(k) for name, k in keys.items()}


def mean_ms(trace: Optional[Dict], name: str) -> Optional[float]:
    """Milliseconds of span ``name`` a unit of work in a traced window's
    summary (``trace.Tracer.summary``), or None where it has none."""
    if not trace or not trace.get("span_units", {}).get(name):
        return None
    return 1e3 * trace["spans"][name]["s"] / trace["span_units"][name]


def innermost_stretches(spans: Sequence[Tuple[str, float, float]]
                        ) -> List[Tuple[float, float, str]]:
    """[(start, end, name)], sorted and disjoint: over each stretch, the
    innermost of the (name, start, end) spans open. Spans of one thread
    nest, so the innermost is the one that began last (of two that began
    together, the shorter). Neighbouring stretches of one name merge."""
    points = sorted({t for s in spans for t in (s[1], s[2])})
    order = sorted(spans, key=lambda s: (s[1], -s[2]))
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[str, float, float]] = []
    i = 0
    for lo, hi in zip(points, points[1:]):
        while i < len(order) and order[i][1] <= lo:
            stack.append(order[i])
            i += 1
        stack = [s for s in stack if s[2] > lo]
        if stack:
            name = max(stack, key=lambda s: (s[1], -s[2]))[0]
            if out and out[-1][2] == name and out[-1][1] == lo:
                out[-1] = (out[-1][0], hi, name)
            else:
                out.append((lo, hi, name))
    return out


def split_idle(gaps: Sequence[Tuple[float, float]],
               stretches: Sequence[Tuple[float, float, str]]
               ) -> Dict[str, float]:
    """Idle seconds by stretch name, and under ``"outside"`` what no
    stretch covers. ``gaps`` are disjoint (in any order); ``stretches``
    are sorted and disjoint."""
    gaps = sorted(gaps)
    out: Dict[str, float] = {}
    i = j = 0
    while i < len(gaps) and j < len(stretches):
        lo = max(gaps[i][0], stretches[j][0])
        hi = min(gaps[i][1], stretches[j][1])
        if hi > lo:
            name = stretches[j][2]
            out[name] = out.get(name, 0.0) + (hi - lo)
        if gaps[i][1] < stretches[j][1]:
            i += 1
        else:
            j += 1
    out[OUTSIDE] = sum(g[1] - g[0] for g in gaps) - sum(out.values())
    return out


def idle_by_span(gaps: Sequence[Tuple[float, float]], spans,
                 thread: int) -> Dict[str, float]:
    """The idle ``gaps`` (seconds) split by the innermost span of
    ``thread`` open over them (:func:`split_idle`)."""
    mine = [(s.name, s.start_ns * 1e-9, s.end_ns * 1e-9)
            for s in spans if s.thread == thread]
    return split_idle(gaps, innermost_stretches(mine))
