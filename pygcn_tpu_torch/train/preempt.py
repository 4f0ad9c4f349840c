"""Preemption-safe training: convert SIGTERM/SIGINT into a clean save+exit.

The port's copy of ``pygcn_tpu/train/preempt.py`` (pure Python). Training
jobs are routinely preempted (maintenance events, spot reclaims,
rescheduling). A training loop that dies between checkpoints loses work; one
that dies *inside* a checkpoint write corrupts it. ``PreemptionGuard`` turns
the first termination signal into a flag the epoch loop polls — the loop
finishes the current epoch, writes a resumable checkpoint (atomic via
``save_checkpoint_state``'s tmp+rename), and exits cleanly so a supervisor can
relaunch with ``--resume``. A second signal restores default handling (so an
impatient ``kill`` still works).

The reference has no analog (SURVEY §5: failure detection "none"); its closest
mechanisms are the incremental CSV flush in gt generation (reference
``gt-gen-vac-fixed-num-cbgs.py:450``) and the RL pickle cache
(``rl-policy-generator.py:136-147``) — both crash-*tolerant*, neither
crash-*aware*. This module makes the trainers themselves preemption-aware.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable


class PreemptionGuard:
    """Context manager that latches termination signals into ``requested``.

    Usage::

        with PreemptionGuard() as guard:
            for epoch in range(epochs):
                train_one_epoch()
                if guard.requested:
                    save_checkpoint(...)
                    break

    Only the main thread may install signal handlers; constructing the guard
    from another thread degrades to an inert guard (``requested`` stays
    False) rather than raising, so library code can use it unconditionally.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev = {}
        self._active = False

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def _handler(self, signum, frame):
        if self._event.is_set():
            # second signal: the user really means it — restore defaults and
            # re-deliver so the process dies with conventional semantics
            self._restore()
            signal.raise_signal(signum)
            return
        self._event.set()

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self  # inert (signal API is main-thread-only)
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._active = True
        return self

    def _restore(self) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._prev.clear()
        self._active = False

    def __exit__(self, *exc) -> None:
        if self._active:
            self._restore()
        return None
