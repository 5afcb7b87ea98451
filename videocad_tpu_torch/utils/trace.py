"""Spans of the program's phases, on the clock of ``torch.profiler``.

A span names a phase of the host's work (a train step's forward, a batch's
assembly or copy) and records when the host entered and
left it::

    with trace.span("step.forward", state.step):
        ...

Recording is off until :func:`enable`; then each span appends a
:class:`Span` to one in-memory list, which :func:`drain` returns and
clears. Off, :func:`span` is one check of a module global that returns a
shared no-op object: no allocation, no clock read, no lock.

Times are ``time.time_ns()``, the Unix-epoch base on which kineto's events
report ``start_ns()``, so spans and a profiler's host and device events
lie on one timeline with no alignment. A span records the host's enqueue
time only: nothing here reads a device value or waits for the device.

``key`` ties the spans of one unit of work together: the step number for
a train step's spans, the batch's ordinal in its epoch for the data
pipeline's. ``parent`` is the name of the span open on the same thread
when this one began. Spans end from any thread; ``list.append`` under the
interpreter lock needs no lock of its own.

A span must not be held open across a generator's ``yield``: the
consumer's spans on the same thread would take it as their parent.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Hashable, List, NamedTuple, Optional


class Span(NamedTuple):
    name: str
    key: Optional[Hashable]
    start_ns: int
    end_ns: int
    parent: Optional[str]
    thread: int


_recording = False
_records: List[Span] = []
_open = threading.local()      # .stack: the spans open on this thread


class _Off:
    """What :func:`span` returns while recording is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "key", "start_ns", "parent", "stack")

    def __init__(self, name: str, key):
        self.name = name
        self.key = key

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1].name if stack else None
        self.stack = stack
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.stack[-1] is self:
            self.stack.pop()
        else:                   # closed out of order: keep the others
            self.stack.remove(self)
        _records.append(Span(self.name, self.key, self.start_ns, end,
                             self.parent, threading.get_ident()))
        return False


def span(name: str, key: Optional[Hashable] = None):
    """A context manager timing the phase ``name`` of unit ``key``."""
    if not _recording:
        return _OFF
    return _On(name, key)


def enable() -> None:
    global _recording
    _recording = True


def disable() -> None:
    """Stop recording new spans; spans open now still end into the list."""
    global _recording
    _recording = False


def drain() -> List[Span]:
    """The spans recorded so far, oldest end first; the list is cleared."""
    out = _records[:]
    del _records[:len(out)]
    return out


def chrome_events(spans: List[Span], base_ns: int = 0) -> List[Dict]:
    """``spans`` as Chrome trace events (complete events, microseconds
    after ``base_ns``, the ``baseTimeNanoseconds`` of the kineto trace they
    join), one track a thread, the key and parent under ``args``."""
    return [{"ph": "X", "name": s.name, "cat": "span", "pid": "spans",
             "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"key": s.key, "parent": s.parent}}
            for s in spans]
