"""Wall-time tracing utilities: the port's own copy of
``rehrseg_tpu.utils.timer`` (reference utils/timer.py:5-16, plus a
step-timing recorder)."""

from __future__ import annotations

import time
from contextlib import contextmanager


@contextmanager
def timer_context(label: str, verbose: bool = True):
    if verbose:
        print(label)
    start_time = time.time()
    try:
        yield
    finally:
        elapsed = time.time() - start_time
        if verbose:
            print(f"\tElapsed time: {elapsed:.4f}s")


class StepTimer:
    """Records per-step wall times and derives throughput statistics.

    First-class metric module for training/inference loops; the reference only
    had tqdm progress bars (misc_utils.py:16-37).
    """

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: list[float] = []
        self._last: float | None = None

    def start(self):
        self._last = time.perf_counter()

    def stop(self) -> float:
        assert self._last is not None, "call start() first"
        dt = time.perf_counter() - self._last
        self.times.append(dt)
        self._last = None
        return dt

    @property
    def steady_times(self) -> list[float]:
        return self.times[self.warmup:] if len(self.times) > self.warmup else self.times

    def mean(self) -> float:
        ts = self.steady_times
        return sum(ts) / max(len(ts), 1)

    def throughput(self, items_per_step: float) -> float:
        m = self.mean()
        return items_per_step / m if m > 0 else 0.0
