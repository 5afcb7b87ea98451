"""Preemption-safe training: SIGTERM -> checkpoint.

Port of ``videocad_tpu/train/preempt.py`` for one process. Fleet
maintenance and spot reclaims deliver SIGTERM with a short grace window;
:class:`PreemptionGuard` turns the signal into a clean stop: the handler
only sets a flag, and the trainer polls ``consensus()`` at log-frequency
boundaries and epoch ends, saves a checkpoint and stops. With one process
``consensus()`` is the local flag; the agreement of all ranks (a global OR,
so that every rank stops at the same step) comes with the parallel slice
(ROADMAP slice 9).
"""

from __future__ import annotations

import signal
from typing import Dict, Tuple


class PreemptionGuard:
    """Installable SIGTERM latch.

    Usage::

        guard = PreemptionGuard().install()
        try:
            ...  # poll guard.consensus()
        finally:
            guard.uninstall()

    ``install``/``uninstall`` save and restore the previous handlers, so
    library users keep their own SIGTERM disposition outside ``train()``.
    Signal handlers only run in the main thread; polling from the train
    loop (also the main thread) needs no locking.
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._prev: Dict[int, object] = {}
        self._flag = False

    def install(self) -> "PreemptionGuard":
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        return self

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def _on_signal(self, signum, frame):
        # Signal context: only set the flag. Saving a checkpoint here would
        # re-enter PyTorch at an arbitrary bytecode boundary.
        self._flag = True

    @property
    def signaled(self) -> bool:
        """This process's flag."""
        return self._flag

    def consensus(self) -> bool:
        """True iff the run should stop: with one process, the local
        flag."""
        return self._flag
