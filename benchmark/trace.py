"""The device trace of a run's window and what the per-layer metrics read
from it.

:class:`Tracer` runs ``torch.profiler`` over a part of the measured window:
one unit of work as the tracer's warm-up (without it the tracer drops the
first short kernels), then the traced span, closed by a device
synchronisation. The arithmetic is a frozen copy of the port's
profile report: device operations are the CUDA events that are not
annotation ranges, busy time is the union of their intervals, and an idle
gap is a stretch of the traced span that no device operation covers,
labelled with the innermost host operation open at its start.

Over the traced span the port's span recorder
(``videocad_tpu_torch/utils/trace.py``) is on, and only there: the
summary gives the spans inside it by name (``benchmark/spans.py``), and
the span's device idle time split by the innermost span of the main
thread open over it. A port without the recorder gives no spans.
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark import spans

_ANNOTATIONS = ("ProfilerStep", "Optimizer.")
_COPIES = re.compile(r"^(Memcpy|Memset)")


def union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for lo, hi in sorted(intervals):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers, longest first."""
    gaps, cursor = [], lo
    for start, end in sorted(intervals):
        if start > cursor:
            gaps.append((cursor, min(start, hi)))
        cursor = max(cursor, end)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])


def _recorder():
    """The port's span recorder, or None where the port has none."""
    try:
        from videocad_tpu_torch.utils import trace as recorder
    except ImportError:
        return None
    return recorder


def _event_fields(e):
    """(name, is_device, start_s, end_s) of a kineto event."""
    name = e.name()
    device = "CUDA" in str(e.device_type())
    if hasattr(e, "start_ns"):
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
    else:
        start = e.start_us() * 1e-6
        end = start + e.duration_us() * 1e-6
    return name, device, start, end


class Tracer:
    """torch.profiler over part of a window, in two spans. The first traces
    the device alone (CUPTI activity, so the host keeps its pace) and gives
    every number: ``start()``, one unit of work (the tracer's warm-up),
    ``begin()``, the traced work, ``stop(units)``. The port's span
    recorder is on from ``begin()`` to ``stop()``; on a machine without a
    card that span records the program's spans alone. The second,
    ``label(work)``, traces the host too over one more unit of work, only
    to name what the host was doing in the device's longest idle gaps; the
    recorder is off there."""

    def __init__(self, enabled: bool, sync):
        self.enabled = enabled
        self.sync = sync
        self.events: List[Tuple[str, bool, float, float]] = []
        self.label_events: List[Tuple[str, bool, float, float]] = []
        self.spans: List = []
        self.window_s: Optional[float] = None
        self.units = 0
        self._device = False
        self._prof = None
        self._t0 = None
        self._lo_ns = self._hi_ns = 0     # the traced span, time.time_ns()
        self._thread = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        # A device trace needs a device: without one only spans are read.
        self._device = self.enabled and torch.cuda.is_available()
        if not self._device:
            return

        def ready(prof):
            self.events = [_event_fields(e) for e in
                           prof.profiler.kineto_results.events()]

        self._prof = profile(activities=[ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1),
                             on_trace_ready=ready)
        self._prof.__enter__()

    def begin(self) -> None:
        if not self.enabled:
            return
        self.sync()
        if self._prof is not None:
            self._prof.step()
        recorder = _recorder()
        if recorder is not None:
            recorder.drain()
            recorder.enable()
        self._thread = threading.get_ident()
        self._t0 = time.perf_counter()
        self._lo_ns = time.time_ns()

    def stop(self, units: int) -> None:
        """Close the traced span after ``units`` units of work."""
        if not self.enabled:
            return
        self.sync()
        self._hi_ns = time.time_ns()
        self.window_s = time.perf_counter() - self._t0
        self.units = units
        recorder = _recorder()
        if recorder is not None:
            recorder.disable()
            self.spans = recorder.drain()
        if self._prof is not None:
            self._prof.step()
            self._prof.__exit__(None, None, None)
            self._prof = None

    def label(self, work) -> None:
        """Run ``work()`` with the host traced as well."""
        if not self._device:
            work()
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            work()
            self.sync()
        self.label_events = [_event_fields(e) for e in
                             prof.profiler.kineto_results.events()]

    def summary(self, top: int = 10) -> Optional[Dict]:
        """busy_s, window_s, kernels, units and device time by name of the
        first span; the program's spans inside it by name (``spans``: count
        and seconds; ``span_units``: the units of work, distinct keys, they
        cover) and its device idle seconds by the innermost span open over
        them (``idle_by_span``, with a device trace only); and the
        breakdown: the device operations that took most time there, and the
        longest idle gaps of the second span by the host operation open at
        their start."""
        if self.window_s is None:
            return None
        device = _device_ops(self.events)
        intervals = [(e[2], e[3]) for e in device]
        by_name: Dict[str, float] = {}
        for name, _, start, end in device:
            by_name[name] = by_name.get(name, 0.0) + (end - start)
        labelled = _device_ops(self.label_events)
        host = sorted((e for e in self.label_events if not e[1]),
                      key=lambda e: e[2])
        gaps = []
        if labelled:
            stretches = [(e[2], e[3]) for e in labelled]
            gaps = idle_gaps(stretches, min(s[0] for s in stretches),
                             max(s[1] for s in stretches))[:top]
        lo_ns, hi_ns = self._lo_ns, self._hi_ns
        idle = {}
        if intervals:
            idle = spans.idle_by_span(
                idle_gaps(intervals, lo_ns * 1e-9, hi_ns * 1e-9),
                self.spans, self._thread)
        return {
            "busy_s": union_seconds(intervals),
            "window_s": self.window_s,
            "kernels": sum(1 for e in device if not _COPIES.match(e[0])),
            "units": self.units,
            "device_s_by_name": by_name,
            "spans": spans.span_totals(self.spans, lo_ns, hi_ns),
            "span_units": spans.span_units(self.spans, lo_ns, hi_ns),
            "idle_by_span": idle,
            "breakdown": {
                "device_ops": [[n[:160], s] for n, s in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:top]],
                "idle_gaps": [[_host_label(host, g[0]), g[1] - g[0]]
                              for g in gaps],
            },
        }


def _device_ops(events):
    return [e for e in events if e[1] and not e[0].startswith(_ANNOTATIONS)]


def _host_label(host: List[Tuple[str, bool, float, float]],
                at: float) -> str:
    """The innermost host operation open at ``at`` (the latest to start
    among those still running), or "host idle"."""
    starts = [e[2] for e in host]
    i = bisect.bisect_right(starts, at)
    best = None
    for e in reversed(host[:i]):
        if e[3] >= at:
            best = e
            break
    return best[0][:120] if best else "host idle"
