"""Graceful preemption handling for long training runs: the port's own
copy of ``rehrseg_tpu.utils.preemption``.

Checkpoints make resume exact (step, params, optimizer state); on
SIGTERM / SIGINT (cluster preemption, ctrl-C) the training loops save a
checkpoint at the CURRENT step before exiting, so a preempted run loses at
most the in-flight step.
"""

from __future__ import annotations

import signal


class TrainingPreempted(Exception):
    """Raised by a training loop after a preemption-triggered save."""

    def __init__(self, step: int):
        super().__init__(f"training preempted at step {step}; "
                         "checkpoint saved — rerun to resume")
        self.step = step


class PreemptionGuard:
    """Installs signal handlers that convert SIGTERM/SIGINT into a polled
    stop request. Training loops check ``should_stop`` once per step (cheap)
    and perform an orderly save. Use as a context manager; the previous
    handlers are restored on exit. A second signal while stopping falls back
    to the default handler (hard kill escape hatch)."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._previous: dict = {}
        self.should_stop = False

    def _handler(self, signum, frame):
        if self.should_stop:
            prev = self._previous.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev if callable(prev) or prev in
                          (signal.SIG_DFL, signal.SIG_IGN) else signal.SIG_DFL)
            # re-deliver so THIS signal terminates as documented (merely
            # restoring the handler would swallow it and require a third)
            signal.raise_signal(signum)
            return
        self.should_stop = True

    def __enter__(self):
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handler)
            except ValueError:
                # not the main thread: polling still works, handlers don't
                pass
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        return False
