"""Preemption-safe training: SIGTERM -> checkpoint.

Port of ``videocad_tpu/train/preempt.py``. Fleet maintenance and spot
reclaims deliver SIGTERM with a short grace window; :class:`PreemptionGuard`
turns the signal into a clean stop: the handler only sets a flag, and the
trainer polls ``consensus()`` at log-frequency boundaries and epoch ends,
saves a checkpoint and stops. ``consensus()`` is a global OR over the
ranks (an all-reduce max of the flag over ``group``), so a signal to one
rank stops every rank at the same step and one checkpoint is written. It is
a collective: every rank calls it at the same points, which the trainer's
equal batch counts guarantee. With one process it is the local flag.
"""

from __future__ import annotations

import signal
from typing import Dict, Tuple

from videocad_tpu_torch.parallel.collectives import any_over


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

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,),
                 group=None, device="cpu"):
        self._signals = tuple(signals)
        self._group = group
        self._device = device
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
        """True iff any rank of the group was signaled: identical on all
        of them."""
        return any_over(self._flag, self._group, self._device)
